"""Driver ``serve``: closed-loop ``DepthCompleter.complete_batch`` calls of
one caller, each a call's worth of the traffic's frames, cycled from a
pool that set-up makes.

Workload keys: ``warm_calls`` (set-up's calls), ``check_calls`` (how many
of the window's calls the check samples, drawn from the seed over every
call the window finished), ``trace_calls`` (the traced stretch after the
window), ``limits``.

The check: for each sampled call, the plain reference runs both stages on
the call's frames and seed; compared are stage 1's pair slots (exact),
its per-pair probabilities and offsets (the widest gap over the valid
pairs), the predicted depth after the RefineNet (frame by frame, the
median gap over the pixels and the share of pixels more than 1 cm off;
the worst frame) and the completed
depth, which holds the input depth bit for bit wherever it is present.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import compare, flops, port, scenes, weights
from benchmark.harness.trace import Spans, activities, summarize
from benchmark.reference import geometry
from benchmark.reference import model as ref

SPANS = ("complete_batch", "device_batch", "forward")
S1_KEYS = ("prob_softmax", "pred_offset", "pair_valid")


class Driver:
    def __init__(self, cell, seed: int, device, trace: bool = False):
        self.cell, self.seed, self.dev, self.trace = cell, seed, device, trace
        self.cfg, self.t, self.w = cell.config, cell.traffic, cell.workload
        self.batch = int(self.t["batch"])
        self.spans = Spans() if trace else None
        self.attempted = self.failed = 0
        self.i = 0              # calls made, set-up's included
        self.kept = {}          # reservoir slot -> a sampled call
        self._slot = None
        self._s1 = None
        self.fault = None       # harness/faults.py

    # -- set-up ----------------------------------------------------------------
    def setup(self):
        from implicit_depth_torch.builder import build_static
        from implicit_depth_torch.infer import DepthCompleter
        h, w = self.t["height"], self.t["width"]
        pcfg = port.config(self.cfg)
        static = build_static(pcfg, n_rays=h * w)
        wts = port.make_weights(self.cfg, self.seed, self.dev)
        lidf, refine = port.models(self.cfg, pcfg, static, wts, self.dev)
        del wts
        self.dc = DepthCompleter(pcfg, lidf=lidf, refine=refine,
                                 batch_size=self.batch, device=self.dev)
        rng = np.random.default_rng([self.seed, 1])
        self.pool = [scenes.frames(rng, self.t) for _ in range(self.t["pool"])]
        self.keep_rng = np.random.default_rng([self.seed, 2])
        self.dc.lidf.register_forward_hook(self._hook)
        if self.fault:
            self.fault(self)
        if self.trace:
            self.spans.wrap(self.dc, "device_batch", "device_batch")
            self.spans.wrap(self.dc, "forward", "forward")
        for _ in range(int(self.w["warm_calls"])):
            self._call()
        if self.trace:  # the profiler's first start-up, out of the window
            with torch.profiler.profile(activities=activities(self.dev)):
                self._call()
        if self.spans:
            self.spans.records.clear()

    def _hook(self, module, args, out):
        if self._slot is not None:
            self._s1 = {k: out[k] for k in S1_KEYS}

    def call_seed(self, i: int) -> int:
        return int(self.seed) * 100_003 + i

    def _call(self):
        fr = self.pool[self.i % len(self.pool)]
        out = self.dc.complete_batch([f["rgb_u8"] for f in fr],
                                     [f["depth"] for f in fr],
                                     [f["intrinsics"] for f in fr],
                                     seed=self.call_seed(self.i))
        self.i += 1
        return out

    # -- the window ------------------------------------------------------------
    def _reservoir(self, j: int):
        k = int(self.w["check_calls"])
        if j < k:
            return j
        r = int(self.keep_rng.integers(0, j + 1))
        return r if r < k else None

    def window(self, seconds: float):
        lat = []
        t0 = time.perf_counter()
        end = t0 + seconds
        t1 = t0
        while t1 < end:
            self._slot = self._reservoir(len(lat))
            i = self.i
            a = time.perf_counter()
            out = self._call()
            t1 = time.perf_counter()
            lat.append(t1 - a)
            if self._slot is not None:
                self.kept[self._slot] = {"i": i, "s1": self._s1, "out": out}
            self._slot = self._s1 = None
        self.window_s, self.lat = t1 - t0, lat
        self.attempted = len(lat)
        self.window_spans = list(self.spans.records) if self.spans else []

    def end_to_end(self):
        return {"serve_frames_per_s": len(self.lat) * self.batch / self.window_s,
                "serve_p95_ms": float(np.percentile(self.lat, 95)) * 1e3}

    def units(self) -> float:
        """Frames completed in the window."""
        return len(self.lat) * self.batch

    def traced_stretch(self):
        self.spans.records.clear()
        self.spans.annotate = True
        n = int(self.w["trace_calls"])
        with torch.profiler.profile(activities=activities(self.dev)) as prof:
            for _ in range(n):
                with self.spans.span("complete_batch"):
                    self._call()
            if self.dev.type == "cuda":
                torch.cuda.synchronize()
        self.traced_iters = n
        return summarize(prof, SPANS)

    # -- work, for the per-layer metrics ------------------------------------
    def decode_images_rays(self):
        """(images, rays an image) of a call's stage-1 decode."""
        return self.batch, self.t["height"] * self.t["width"]

    def model_flops(self) -> float:
        """The reference's operations a call, at the call's shapes."""
        return flops.serve(self.cfg, self.t)

    # -- the check ---------------------------------------------------------------
    def release(self):
        self.kept = {s: {"i": c["i"], "out": c["out"],
                         "s1": {k: v.cpu() for k, v in c["s1"].items()}}
                     for s, c in self.kept.items()}
        del self.dc
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def check(self):
        return compare.judge(self.readings(), self.w.get("limits", {}))

    def readings(self, precision: str = "f32", against=None):
        """The compared numbers of the sampled calls: the program's, or
        with ``against`` (a precision) that reference's in its place."""
        with compare.reference_numerics():
            return self._readings(precision, against)

    def _readings(self, precision, against):
        wts = port.make_weights(self.cfg, self.seed, self.dev)
        p1, p2 = weights.split(wts, "lidf."), weights.split(wts, "refine.")
        calls = [self.kept[s] for s in sorted(self.kept)]
        r = {"input_depth_changed": 0.0, "pair_slots_differ": 0.0,
             "prob_gap": 0.0, "offset_gap": 0.0, "depth_median_gap_m": 0.0,
             "depth_off_1cm_pct": 0.0}
        for c in calls:
            want = self.reference_call(c["i"], p1, p2, ref.Precision(precision))
            got = c if against is None else self.reference_call(
                c["i"], p1, p2, ref.Precision(against))
            fr = self.pool[c["i"] % len(self.pool)]
            d_in = np.stack([f["depth"] for f in fr])
            have = d_in != 0
            r["input_depth_changed"] += float(
                (got["out"]["depth"][have] != d_in[have]).sum())
            pv_g, pv_w = got["s1"]["pair_valid"], want["s1"]["pair_valid"]
            r["pair_slots_differ"] += float((pv_g != pv_w).sum())
            both = pv_g & pv_w
            for key, name in (("prob_softmax", "prob_gap"),
                              ("pred_offset", "offset_gap")):
                gap = (got["s1"][key].float() - want["s1"][key])[both].abs()
                r[name] = max(r[name], float(gap.max()) if gap.numel() else 0.0)
            for dz in np.abs(got["out"]["depth_pred"]
                             - want["out"]["depth_pred"]):  # frame by frame
                r["depth_median_gap_m"] = max(r["depth_median_gap_m"],
                                              float(np.median(dz)))
                r["depth_off_1cm_pct"] = max(r["depth_off_1cm_pct"],
                                             100.0 * float((dz > 0.01).mean()))
        return r

    @torch.no_grad()
    def reference_call(self, i, p1, p2, prec):
        """The reference's stage-1 outputs and depths of call ``i``."""
        fr = self.pool[i % len(self.pool)]
        dev = self.dev

        def t(x):
            return torch.as_tensor(np.ascontiguousarray(x), device=dev)

        rgb = t(np.stack([scenes.standardize(f["rgb_u8"]) for f in fr]))
        depth = t(np.stack([f["depth"] for f in fr]))
        fx, fy, cx, cy = t(np.asarray([f["intrinsics"] for f in fr],
                                      np.float32).T.copy())
        batch = {"rgb": rgb, "depth_corrupt": depth,
                 "xyz_corrupt": geometry.compute_xyz(depth, fx, fy, cx, cy),
                 "xyz": torch.zeros(depth.shape + (3,), device=dev),
                 "corrupt_mask": (depth == 0).float(),
                 "valid_mask": (depth != 0).float(),
                 "fx": fx, "fy": fy, "cx": cx, "cy": cy}
        gen = torch.Generator(device=dev).manual_seed(self.call_seed(i))
        cfg = {**self.cfg, "_grid": geometry.make_grid(self.cfg["grid"]["res"])}
        inp = geometry.prepare(cfg["_grid"], batch, train=False,
                               n_valid=cfg["grid"]["valid_sample_num"],
                               n_rays=0, k_pairs=cfg["tpu"]["max_pairs_per_ray"],
                               gen=gen)
        s1 = ref.lidf_forward(p1, cfg, inp, train=False, use_gt=False,
                              prec=prec)
        pred = ref.refine_forward(p2, cfg, inp, s1, prec) if p2 \
            else s1["pred_pos"]
        h, w = depth.shape[-2:]
        pred_z = pred[..., 2].reshape(-1, h, w)
        done = torch.where(depth == 0, pred_z, depth)
        return {"s1": {k: s1[k].cpu() for k in S1_KEYS},
                "out": {"depth": done.cpu().numpy(),
                        "depth_pred": pred_z.cpu().numpy()}}
