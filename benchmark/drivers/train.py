"""Driver ``train``: closed-loop training steps of the program's
``make_lidf_train_step`` (``stage`` "lidf") or ``make_refine_train_step``
(``stage`` "refine", stage 1 frozen), each host batch through
``train/trainer.py::to_device`` and its losses read back one step late, as
the trainer's epoch loop does. Set-up makes a pool of distinct batches
from the seed, which the window cycles (the loader is bypassed).

Workload keys: ``stage``, ``epoch`` (the epoch the steps are taken in,
for the curriculum and the loss gates), ``checked_steps`` (set-up's first
steps, which the check follows), ``warm_steps``, ``trace_steps``,
``limits``.

The check: one train state is built, and set-up drives it from the seed
through its first ``checked_steps`` steps (each on its own batch) and
hands it to the window. The plain reference takes the same steps from the
same weights, batches and draws, in float32. Compared: each step's loss;
the first step's gradient of each trained leaf, as Adam's first moment
holds it after that step; each leaf's change over the checked steps. By
leaf, the gap between the two norms over the larger of the reference's
norm of that leaf and of the median leaf; leaves whose reference gradient
is under a thousandth of the median leaf's move by rounding alone and
are left out of the change.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from benchmark.harness import compare, flops, port, scenes, weights
from benchmark.harness.trace import Spans, activities, summarize
from benchmark.reference import geometry
from benchmark.reference import model as ref

SPANS = ("step", "to_device", "step_call", "read_back")
TINY_GRAD = 1e-3


class Driver:
    def __init__(self, cell, seed: int, device, trace: bool = False):
        self.cell, self.seed, self.dev, self.trace = cell, seed, device, trace
        self.cfg, self.t, self.w = cell.config, cell.traffic, cell.workload
        self.stage = self.w["stage"]
        self.epoch = int(self.w.get("epoch", 0))
        self.batch = int(self.t["batch"])
        self.spans = Spans() if trace else None
        self.attempted = self.failed = 0
        self.i = 0
        self.fault = None       # harness/faults.py

    # -- set-up ----------------------------------------------------------------
    def setup(self):
        from implicit_depth_torch.builder import build_static
        from implicit_depth_torch.train.state import TrainState
        from implicit_depth_torch.train.steps import (
            make_lidf_train_step,
            make_refine_train_step,
        )
        from implicit_depth_torch.train.trainer import to_device
        self._to_device = to_device
        pcfg = port.config(self.cfg)
        static = build_static(pcfg)
        wts = port.make_weights(self.cfg, self.seed, self.dev)
        lidf, refine = port.models(self.cfg, pcfg, static, wts, self.dev)
        if self.stage == "lidf":
            model, self.step_fn = lidf, make_lidf_train_step(pcfg, lidf,
                                                             self.dev)
        else:
            model = refine
            self.step_fn = make_refine_train_step(pcfg, lidf, refine, self.dev)
        self.model = model
        # the schedule's first epochs: the steps run at the base rate
        self.state = TrainState.create(model, pcfg.training,
                                       steps_per_epoch=1 << 40)
        self.gen = torch.Generator(device=self.dev).manual_seed(self.seed)
        if self.fault:
            self.fault(self)
        rng = np.random.default_rng([self.seed, 1])
        self.pool = [scenes.train_batch(rng, self.t)
                     for _ in range(self.t["pool"])]
        w0 = port.make_weights(self.cfg, self.seed, self.dev)
        pre = self.stage + "."
        trained = [(n, p) for n, p in model.named_parameters()
                   if p.requires_grad]
        self.prog = {"loss": [], "g1": {}, "delta": {}}
        beta1 = self.state.optimizer.param_groups[0]["betas"][0]
        for k in range(int(self.w["checked_steps"])):
            losses = self._step()
            self.prog["loss"].append(float(losses["loss_net"]))
            if k == 0:
                st = self.state.optimizer.state
                self.prog["g1"] = {
                    n: float(st[p]["exp_avg"].norm()) / (1 - beta1)
                    if "exp_avg" in st.get(p, {}) else 0.0
                    for n, p in trained}
        self.prog["delta"] = {n: float((p.detach() - w0[pre + n]).norm())
                              for n, p in trained}
        del w0, wts
        for _ in range(int(self.w["warm_steps"])):
            self._read(self._step())
        if self.trace:  # the profiler's first start-up, out of the window
            with torch.profiler.profile(activities=activities(self.dev)):
                self._read(self._step())
        if self.spans:
            self.spans.records.clear()

    def _step(self):
        hb = self.pool[self.i % len(self.pool)]
        self.i += 1
        sp = self.spans.span if self.spans else _no_span
        with sp("to_device"):
            db = self._to_device(hb, self.dev)
        with sp("step_call"):
            return self.step_fn(self.state, db, self.gen, self.epoch)

    def _read(self, losses):
        sp = self.spans.span if self.spans else _no_span
        with sp("read_back"):
            return torch.stack([v.float() for v in losses.values()]).cpu()

    # -- the window ------------------------------------------------------------
    def window(self, seconds: float):
        n, pending = 0, None
        t0 = time.perf_counter()
        end = t0 + seconds
        while time.perf_counter() < end or n == 0:
            losses = self._step()
            if pending is not None:
                self._read(pending)
            pending, n = losses, n + 1
        self._read(pending)
        self.window_s = time.perf_counter() - t0
        self.steps = self.attempted = n
        self.window_spans = list(self.spans.records) if self.spans else []

    def end_to_end(self):
        return {"train_samples_per_s": self.units() / self.window_s}

    def units(self) -> float:
        """Samples whose step completed in the window."""
        return self.steps * self.batch

    def traced_stretch(self):
        self.spans.records.clear()
        self.spans.annotate = True
        n = int(self.w["trace_steps"])
        pending = None
        with torch.profiler.profile(activities=activities(self.dev)) as prof:
            for _ in range(n):
                with self.spans.span("step"):
                    losses = self._step()
                    if pending is not None:
                        self._read(pending)
                    pending = losses
            self._read(pending)
            if self.dev.type == "cuda":
                torch.cuda.synchronize()
        self.traced_iters = n
        return summarize(prof, SPANS)

    # -- work, for the per-layer metrics ------------------------------------
    def decode_images_rays(self):
        """(images, rays an image) of a step's stage-1 decode."""
        return self.batch, self.cfg["grid"]["miss_sample_num"]

    def model_flops(self) -> float:
        return flops.train(self.cfg, self.t, self.stage, self.epoch)

    # -- the check ---------------------------------------------------------------
    def release(self):
        del self.state, self.step_fn, self.model
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def check(self):
        return compare.judge(self.readings(), self.w.get("limits", {}))

    def readings(self, precision: str = "f32", against=None):
        """The compared numbers: the program's checked steps, or with
        ``against`` (a precision) that reference's in their place."""
        want = self.reference_steps(precision)
        got = self.prog if against is None else self.reference_steps(against)
        leaves = list(want["g1"])
        med = float(np.median([want["g1"][k] for k in leaves]))
        moved = [k for k in leaves if want["g1"][k] >= TINY_GRAD * med]
        loss = [abs(a - b) / abs(b) for a, b in zip(got["loss"], want["loss"])]
        grad = compare.leaf_gaps(got["g1"], want["g1"], leaves)
        change = compare.leaf_gaps(got["delta"], want["delta"], moved)
        return {"loss1_gap": loss[0], "loss_gap": max(loss),
                "grad_norm_gap": max(grad),
                "grad_norm_gap_median": float(np.median(grad)),
                "change_gap": max(change),
                "change_gap_median": float(np.median(change))}

    def reference_steps(self, precision: str):
        """The reference's checked steps: losses, the first gradient's and
        the change's norms by leaf."""
        with compare.reference_numerics():
            return self._reference_steps(precision)

    def _reference_steps(self, precision: str):
        prec = ref.Precision(precision)
        cfg = {**self.cfg, "_grid": geometry.make_grid(self.cfg["grid"]["res"])}
        hw = (self.t["height"], self.t["width"])
        wts = port.make_weights(self.cfg, self.seed, self.dev)
        p1, p2 = weights.split(wts, "lidf."), weights.split(wts, "refine.")
        p = p1 if self.stage == "lidf" else p2
        spec = ref.lidf_spec(cfg) if self.stage == "lidf" \
            else ref.refine_spec(cfg)
        names = ref.names_with_grad(spec)
        w0 = {n: p[n].clone() for n in names}
        for n in names:
            p[n] = p[n].clone().requires_grad_(True)
        tr = self.cfg["training"]
        lr, b1, b2, eps = float(tr["lr"]), 0.9, 0.999, 1e-8
        m = {n: torch.zeros_like(p[n]) for n in names}
        v = {n: torch.zeros_like(p[n]) for n in names}
        gen = torch.Generator(device=self.dev).manual_seed(self.seed)
        out = {"loss": [], "g1": {}, "delta": {}}
        for k in range(int(self.w["checked_steps"])):
            batch = {key: torch.as_tensor(val, device=self.dev)
                     for key, val in self.pool[k].items()}
            inp = geometry.prepare(cfg["_grid"], batch, train=True,
                                   n_valid=cfg["grid"]["valid_sample_num"],
                                   n_rays=cfg["grid"]["miss_sample_num"],
                                   k_pairs=cfg["tpu"]["max_pairs_per_ray"],
                                   gen=gen)
            if self.stage == "lidf":
                o = ref.lidf_forward(
                    p, cfg, inp, train=True,
                    use_gt=self.epoch < cfg["model"]["maxpool_label_epo"],
                    prec=prec)
                loss = ref.lidf_loss(inp, o, cfg["loss"], hw, self.epoch)
            else:
                with torch.no_grad():
                    s1 = ref.lidf_forward(p1, cfg, inp, train=False,
                                          use_gt=False, prec=prec)
                pred = ref.refine_forward(p, cfg, inp, s1, prec, gen,
                                          bool(cfg["refine"]["perturb"]))
                loss = ref.refine_loss(inp, pred, cfg["loss"], hw, self.epoch)
            grads = torch.autograd.grad(loss, [p[n] for n in names])
            out["loss"].append(float(loss.detach()))
            with torch.no_grad():
                for n, g in zip(names, grads):
                    if k == 0:
                        out["g1"][n] = float(g.norm())
                    m[n].mul_(b1).add_(g, alpha=1 - b1)
                    v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                    mh = m[n] / (1 - b1 ** (k + 1))
                    vh = v[n] / (1 - b2 ** (k + 1))
                    p[n].sub_(lr * mh / (vh.sqrt() + eps))
            del inp, grads, loss
        out["delta"] = {n: float((p[n].detach() - w0[n]).norm())
                        for n in names}
        return out


def _no_span(name):
    return contextlib.nullcontext()
