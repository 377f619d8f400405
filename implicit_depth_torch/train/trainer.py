"""Trainers: stage-1 LIDF and stage-2 Refine (counterpart of
``implicit_depth_tpu/train/trainer.py``).

Parity: ``TrainLIDF`` (src/trainers/train_lidf.py:37-664) and ``TrainRefine``
(train_refine.py:36-663) — setup (dirs, auto log-name, config dump), model +
optimizer + checkpoint/resume, train/valid/test loops with meters, JSONL
epoch logs, per-image CSV at test, PLY/PNG visualization.

One process drives one device (``device``, default ``cuda``; raises without
a card unless ``"cpu"`` is asked for). Under a process group
(``parallel/mesh.py``, one process per rank, as the JAX trainer runs one
process per host) ``training.batch_size`` is the global batch, and the
ranks take JAX's ``("data", "rays")`` layout (``mesh.use_layout``, the
rule of the JAX trainer's mesh): each rank loads the block of ``batch_size
// data`` samples of its data index of every global batch (the ranks of a
rays group the same block), its steps decode its block of those images'
rays and make the update of one process on the global batch (see
``train/steps.py``), its logged losses are summed over the ranks into the
global batch's, and only rank 0 writes files (logs, checkpoints, the test
CSV, visual dumps). Validation and test run every frame on every rank,
each rank on its block of the frame's rays. The
trainer's random draws (valid points, ray windows, the stage-2
perturbation) come from one ``torch.Generator`` on that device, seeded from
``cfg.seed``; the initial weights from a CPU generator of the same seed, so
that a run starts from the same weights on any device. Host batches go to
the device through pinned memory (:func:`to_device`). A train "item" is
``tpu.train_steps_per_call`` single steps run back to back; its losses are
read back one item late, in one copy, and the mid-epoch checkpoints
(``training.ckpt_every_steps``) are checked after each item, so that they
land on the step counts of the JAX trainer's.
"""

from __future__ import annotations

import csv
import itertools
import json
import os
import os.path as osp
import time
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from implicit_depth_torch.builder import build_lidf, build_refine, build_static
from implicit_depth_torch.config import Config
from implicit_depth_torch.data.datasets import get_dataset
from implicit_depth_torch.data.loader import DataLoader
from implicit_depth_torch.infer import resolve_device
from implicit_depth_torch.parallel import mesh
from implicit_depth_torch.train.checkpoint import (
    Checkpointer,
    generator_state,
    restore_params_only,
    set_generator_state,
)
from implicit_depth_torch.train.metrics import (
    MeterBank,
    cleargrasp_metrics,
    depth_images_from_outputs,
)
from implicit_depth_torch.train.state import TrainState
from implicit_depth_torch.train.steps import (
    make_lidf_eval_step,
    make_lidf_train_step,
    make_refine_eval_step,
    make_refine_train_step,
)
from implicit_depth_torch.utils import profiling

VALID_SPLITS = (("cleargrasp_synthetic", "known"), ("cleargrasp_synthetic", "novel"),
                ("cleargrasp_real", "known"), ("cleargrasp_real", "novel"))

_LIDF_LOG_KEYS = ("loss_net", "pos_loss", "prob_loss", "acc", "err")
_REFINE_LOG_KEYS = ("loss_net", "pos_loss", "err")
_CSV_HEADER = ["Image Num", "RMSE", "REL", "MAE", "Delta 1.05", "Delta 1.10",
               "Delta 1.25"]

Device = Union[str, torch.device]


def auto_log_name(cfg: Config, stage: str) -> str:
    """≙ the reference's hyperparameter-encoding run name
    (train_lidf.py:208-247)."""
    m, g, t, l = cfg.model, cfg.grid, cfg.training, cfg.loss
    parts = [
        stage, f"res{g.res}", f"miss{g.miss_sample_num}", f"valid{g.valid_sample_num}",
        f"bs{t.batch_size}", f"lr{t.lr}", m.offdec_type.lower(),
        f"rgb{m.rgb_out}", f"pnet{m.pnet_out}", f"posw{l.pos_w}",
        f"probw{l.prob_w}", f"snw{l.surf_norm_w}",
    ]
    if l.hard_neg:
        parts.append(f"hardneg{l.hard_neg_ratio}")
    if cfg.custom_postfix:
        parts.append(cfg.custom_postfix)
    return "_".join(str(p) for p in parts)


@profiling.spanned("train.to_device")
def to_device(batch: Dict[str, np.ndarray],
              dev: torch.device) -> Dict[str, torch.Tensor]:
    """A host batch's arrays (``item_path`` left out) as tensors on ``dev``:
    on a card through pinned memory with non-blocking copies, so that the
    copies queue behind the running step instead of waiting for it."""
    out = {}
    for k, v in batch.items():
        if k == "item_path":
            continue
        t = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = (t.pin_memory().to(dev, non_blocking=True)
                  if dev.type == "cuda" else t)
    return out


def _host_scalars(values: List[Dict[str, torch.Tensor]],
                  sum_ranks: bool = False) -> List[Dict[str, float]]:
    """Loss dicts of 0-d tensors -> floats, read back in one copy;
    ``sum_ranks``: each summed over the ranks first, in one all-reduce
    (the train steps' losses are each rank's share of the global batch's)."""
    if not values:
        return []
    keys = list(values[0])
    stacked = torch.stack([torch.stack([d[k].float() for k in keys])
                           for d in values])
    if sum_ranks:
        stacked = mesh.all_reduce_sum(stacked)
    return [dict(zip(keys, row)) for row in stacked.cpu().tolist()]


_TIMING_PHASES = ("feed_wait", "dispatch", "harvest")


def _seconds(totals, phase: str) -> float:
    return totals.get("train." + phase, (0, 0.0))[1]


class BaseTrainer:
    stage = "base"

    def __init__(self, cfg: Config, workdir: Optional[str] = None,
                 device: Device = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.rank, self.world, self.is_main = (mesh.rank(), mesh.world(),
                                               mesh.is_main())
        # the ("data", "rays") layout of the ranks (JAX trainer.py:77-93);
        # the global batch's block of this rank's data index
        self.layout = mesh.use_layout(int(cfg.training.batch_size))
        self.per_host_batch = int(cfg.training.batch_size) // self.layout.data
        self.seed = int(cfg.seed or 0)
        self.generator = torch.Generator(device=self.device).manual_seed(
            self.seed)

        self.log_name = cfg.log_name or auto_log_name(cfg, self.stage)
        self.workdir = workdir or osp.join(cfg.base_log_dir or "logs", self.log_name)
        self.ckpt_dir = osp.join(self.workdir, "ckpt")
        self.vis_dir = osp.join(self.workdir, "vis")
        self.result_dir = osp.join(self.workdir, "result")
        if self.is_main:
            for d in (self.workdir, self.ckpt_dir, self.vis_dir,
                      self.result_dir):
                os.makedirs(d, exist_ok=True)
            cfg.save(osp.join(self.workdir, "config.yaml"))
        self.ckpt = Checkpointer(self.ckpt_dir)
        self.meters = MeterBank()
        self.epoch_log_path = osp.join(self.workdir, "epoch_log.jsonl")
        self.valid_log_path = osp.join(self.workdir, "valid_log.txt")
        # best-metric scalars tracked across epochs AND resumes
        # (≙ train_lidf.py:85-112 min_err/max_acc/min_angle_err + :317-322)
        self.best = {"min_err": 1e5, "max_acc": -1.0, "min_angle_err": 1e5}
        self._resume_skip_steps = 0

    def _init_weights_generator(self) -> torch.Generator:
        """The CPU generator the initial weights are drawn from."""
        return torch.Generator().manual_seed(self.seed)

    def _restore(self) -> bool:
        """Resume from ``latest_network`` (``cfg.resume``) when there is
        one; sets ``start_epoch``. Returns whether it resumed."""
        self.start_epoch = 0
        if not (self.cfg.resume and self.ckpt.latest_exists()):
            return False
        self.state, meta = self.ckpt.restore(self.state)
        self.start_epoch = self._apply_resume_meta(meta)
        return True

    def _replicate(self, *modules) -> None:
        """Rank 0's weights, optimizer and generator states on every rank
        (after init and after a restore; every rank read the same files)."""
        mesh.replicate_state(*modules, optimizer=self.state.optimizer,
                             generator=self.generator)

    def _log_setup(self) -> None:
        if self.world > 1:
            lay = self.layout
            print(f"[rank {self.rank}/{self.world}] per_host_batch "
                  f"{self.per_host_batch} steps_per_epoch "
                  f"{self.steps_per_epoch} device {self.device} layout "
                  f"data {lay.data} x rays {lay.rays} at data "
                  f"{lay.data_index}, rays {lay.ray_index}", flush=True)

    def _update_best(self, record: Dict) -> bool:
        """Fold this epoch's metrics into the best scalars; returns True when
        the position error improved (triggers the best_network snapshot)."""
        src = record.get("valid") or {}
        if src:  # average the per-split validation means
            splits = list(src.values())
            agg = {k: float(np.mean([s[k] for s in splits if k in s]))
                   for k in splits[0]}
        else:
            agg = record.get("train", {})
        improved = False
        if "err" in agg and agg["err"] < self.best["min_err"]:
            self.best["min_err"] = agg["err"]
            improved = True
        if "acc" in agg and agg["acc"] > self.best["max_acc"]:
            self.best["max_acc"] = agg["acc"]
        if "angle_err" in agg and agg["angle_err"] < self.best["min_angle_err"]:
            self.best["min_angle_err"] = agg["angle_err"]
        return improved

    def _save_epoch(self, epoch: int, record: Dict) -> None:
        """Checkpoint + JSONL log for one epoch: latest every epoch, periodic
        snapshots, and a ``best_network`` copy when the tracked error improved
        (≙ train_lidf.py:317-371)."""
        improved = self._update_best(record)
        meta = dict(self.best)
        self.ckpt.save(self.state, epoch, meta=meta,
                       snapshot=(epoch % self.cfg.training.nepoch_ckpt == 0))
        if improved:
            self.ckpt.save_as(self.state, epoch, "best_network", meta=meta)
        self.log_epoch(epoch, {**record, "best": dict(self.best)})

    def _should_validate(self, epoch: int) -> bool:
        """Reference: validate every epoch (train_lidf.py:292-315);
        ``training.valid_interval=N`` thins that to every Nth epoch past
        ``valid_start_epo`` (the last epoch always validates so best-metric
        tracking sees the final state)."""
        t = self.cfg.training
        if not t.do_valid or epoch < t.valid_start_epo:
            return False
        interval = int(t.get("valid_interval", 1) or 1)
        return (epoch == t.nepochs - 1
                or (epoch - t.valid_start_epo) % interval == 0)

    def _maybe_recycle(self, epoch: int) -> None:
        """Host-RSS recycle guard (``tpu.host_rss_exit_gb``): when the
        process's resident memory crosses the limit, exit(82) right after
        the epoch checkpoint, so that an outer retry loop restarts with
        ``resume=latest_network``; under a process group every rank exits
        when one crosses it. 0 (the default) disables it."""
        limit_gb = float(self.cfg.tpu.get("host_rss_exit_gb", 0) or 0)
        if not limit_gb:
            return
        try:
            with open("/proc/self/statm") as f:
                rss_gb = int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 1e9
        except (OSError, ValueError):
            rss_gb = 0.0
        over = mesh.all_reduce_sum(torch.tensor([float(rss_gb > limit_gb)]))
        if over.item() > 0:
            print(f"[recycle] host RSS {rss_gb:.1f} GB > {limit_gb:.0f} GB "
                  f"after epoch {epoch} — exiting for a clean resume",
                  flush=True)
            raise SystemExit(82)

    # -- mid-epoch (preemption-safe) checkpointing ---------------------------
    def _apply_resume_meta(self, meta: Dict) -> int:
        """Digest a restored checkpoint's metadata: best scalars always; a
        mid-epoch snapshot (``step_in_epoch`` present) additionally restores
        the generator's state and arms the step-skip so the interrupted
        epoch resumes at the exact optimizer step. Returns the epoch to start
        at."""
        self.best.update({k: meta[k] for k in self.best if k in meta})
        self._resume_skip_steps = 0
        if meta.get("step_in_epoch"):
            self._resume_skip_steps = int(meta["step_in_epoch"])
            if "generator" in meta:
                set_generator_state(self.generator, meta["generator"])
            start = int(meta["mid_epoch"])
            print(f"resumed MID-epoch {start} at step "
                  f"{self._resume_skip_steps} (best {self.best})")
            return start
        start = int(meta.get("epoch", -1)) + 1
        print(f"resumed from epoch {start - 1} (best {self.best})")
        return start

    def _maybe_step_ckpt(self, epoch: int, steps_done: int) -> None:
        """Write latest_network mid-epoch every ``ckpt_every_steps`` optimizer
        steps (item granularity: saves land on item boundaries). Meta
        records the in-progress epoch, the step count, and the generator's
        state so ``_apply_resume_meta`` restores the exact loop position;
        the epoch-end save overwrites with step-free meta. Meters restart on
        a mid-epoch resume, so that epoch's logged means cover the
        remainder."""
        every = int(self.cfg.training.get("ckpt_every_steps", 0) or 0)
        if not every:
            return
        prev = getattr(self, "_last_step_ckpt", 0)
        if steps_done // every <= prev // every:
            return
        self._last_step_ckpt = steps_done
        meta = dict(self.best, mid_epoch=epoch, step_in_epoch=steps_done,
                    generator=generator_state(self.generator))
        self.ckpt.save(self.state, epoch - 1, meta=meta, snapshot=False)

    # -- data ---------------------------------------------------------------
    def make_train_loader(self) -> DataLoader:
        cfg = self.cfg
        ds = get_dataset(cfg.dataset, "train", base_seed=self.seed)
        return DataLoader(ds, self.per_host_batch, shuffle=True,
                          seed=self.seed, num_workers=cfg.training.num_workers,
                          host_id=self.layout.data_index,
                          num_hosts=self.layout.data,
                          worker_type=cfg.training.get("worker_type", "thread"))

    def make_valid_loaders(self) -> Dict[str, DataLoader]:
        cfg = self.cfg
        out = {}
        if cfg.dataset.type == "synthetic":
            ds = get_dataset(cfg.dataset, "valid")
            out["synthetic"] = DataLoader(ds, cfg.training.valid_batch_size,
                                          shuffle=False, num_workers=2)
            return out
        for dtype, obj in VALID_SPLITS:
            try:
                sub = Config(cfg.dataset.to_dict())
                sub.type = dtype
                ds = get_dataset(sub, "valid", obj_type=obj)
                if len(ds):
                    out[f"{dtype.split('_')[-1]}_{obj}"] = DataLoader(
                        ds, cfg.training.valid_batch_size, shuffle=False,
                        num_workers=2)
            except (FileNotFoundError, OSError):
                continue
        return out

    def log_epoch(self, epoch: int, record: Dict) -> None:
        if not self.is_main:
            return
        with open(self.epoch_log_path, "a") as f:
            f.write(json.dumps({"epoch": epoch, **record}) + "\n")

    def _train_steps_per_call(self) -> int:
        """Optimizer steps per item (``tpu.train_steps_per_call``), forced
        to 1 when per-step host batches are needed (debug truncation,
        train-time visualization)."""
        cfg = self.cfg
        if cfg.debug or cfg.training.get("train_vis_iter", 0):
            return 1
        return max(int(cfg.tpu.get("train_steps_per_call", 1) or 1), 1)

    def _item_sizes(self, n_steps: int) -> List[int]:
        """The steps of each item of an epoch's ``n_steps``: items of
        ``_train_steps_per_call`` steps, the remainder one step an item (as
        the JAX feed ships it)."""
        k = self._train_steps_per_call()
        return [k] * (n_steps // k) + [1] * (n_steps % k)

    def _run_train_epoch(self, epoch: int, run_one, tag: str,
                         log_keys) -> Dict[str, float]:
        """Shared train-epoch loop. ``run_one(device_batch)`` runs one
        step and returns its loss tensors; the losses of an item are read
        back one item LATE, so that the device has the next item queued
        while the host reads. ``IDT_TIMING`` turns tracing on for the epoch
        and prints the sums of its ``train.feed_wait``, ``train.dispatch``
        and ``train.harvest`` spans."""
        timing = bool(os.environ.get("IDT_TIMING"))
        if timing:
            profiling.enable()
        try:
            before = profiling.span_totals()
            means = self._train_epoch_items(epoch, run_one, tag, log_keys)
            after = profiling.span_totals()
        finally:
            if timing:
                profiling.disable()
        if timing:
            # harvest(last) is where the queued device work drains, so it
            # reads as "device time the host could not overlap"
            print(f"[timing] rank {self.rank} epoch {epoch} " + " ".join(
                f"{k}={_seconds(after, k) - _seconds(before, k):.2f}s"
                for k in _TIMING_PHASES), flush=True)
        return means

    def _train_epoch_items(self, epoch: int, run_one, tag: str,
                           log_keys) -> Dict[str, float]:
        cfg = self.cfg
        self.meters.reset()
        t_start = time.time()
        pending = None
        skip = self._resume_skip_steps
        self._resume_skip_steps = 0  # only the interrupted epoch skips
        self._last_step_ckpt = skip
        it = skip - 1
        # the epoch-seeded order, its first `skip` batches dropped (a
        # mid-epoch resume); each batch is stepped as soon as it arrives
        batches = itertools.islice(self.train_loader.epoch(epoch), skip, None)
        for size in self._item_sizes(self.train_loader.steps_per_epoch()
                                     - skip):
            if cfg.debug and it >= 4:
                break
            first, losses = it + 1, []
            for _ in range(size):
                with profiling.span("train.feed_wait"):
                    batch = next(batches)
                with profiling.span("train.dispatch"):
                    dev_batch = to_device(batch, self.device)
                    losses.append(run_one(dev_batch))
                    it += 1
                    self._train_vis(epoch, it, batch, dev_batch)
            if pending is not None:  # harvest the PREVIOUS item (overlapped)
                with profiling.span("train.harvest"):
                    self._harvest_losses(epoch, pending, tag, log_keys)
            pending = (first, losses)
            self._maybe_step_ckpt(epoch, it + 1)
        if pending is not None:
            with profiling.span("train.harvest"):
                self._harvest_losses(epoch, pending, tag, log_keys)
        means = self.meters.means()
        means["epoch_time_s"] = time.time() - t_start
        return means

    def _harvest_losses(self, epoch: int, pending, tag: str, log_keys) -> None:
        """Read back one item's loss scalars (the global batch's) in a
        single copy and add them to the meters, logging every
        ``log_interval`` steps."""
        it0, losses = pending
        for j, vals in enumerate(_host_scalars(losses, sum_ranks=True)):
            self.meters.add(vals)
            if self.is_main and (it0 + j) % self.cfg.training.log_interval == 0:
                msg = " ".join(f"{k}={v:.4f}" for k, v in vals.items()
                               if k in log_keys)
                print(f"[{tag}] epoch {epoch} it {it0 + j}/"
                      f"{self.steps_per_epoch} {msg}", flush=True)

    def _train_vis(self, epoch: int, it: int, batch, dev_batch) -> None:
        """Train-time visualization (≙ train_lidf.py:469-473): dump visuals
        ``train_vis_iter`` times per epoch on the current training batch.
        Every rank runs the vis step (its draws keep the generators in
        step); rank 0 writes its own block's visuals."""
        vis_iter = self.cfg.training.get("train_vis_iter", 0)
        if not vis_iter:
            return
        period = max(self.steps_per_epoch // int(vis_iter), 1)
        if it % period != 0:
            return
        if self._vis_step is None:
            self._vis_step = self._make_vis_step()
        inputs, pred = self._vis_step(self.state, dev_batch, self.generator)
        if not self.is_main:
            return
        from implicit_depth_torch.train.visualize import dump_batch_visuals
        dump_batch_visuals(self.vis_dir, f"train_ep{epoch}_it{it}", batch,
                           inputs, pred)

    # -- eval ---------------------------------------------------------------
    def _eval(self, dev_batch):
        """(inputs, pred_pos, losses) of one eval batch."""
        raise NotImplementedError

    def validate(self, epoch: int, max_batches: Optional[int] = None) -> Dict[str, Dict]:
        cfg = self.cfg
        results = {}
        h, w = cfg.dataset.img_height, cfg.dataset.img_width
        vis_iter = cfg.training.get("val_vis_iter", 0)
        for split, loader in self.make_valid_loaders().items():
            bank = MeterBank()
            for it, batch in enumerate(loader.epoch(0)):
                if cfg.debug and it >= 5:
                    break
                if max_batches and it >= max_batches:
                    break
                inputs, pred, losses = self._eval(to_device(batch, self.device))
                # each rank's share of the frames' losses
                bank.add(_host_scalars([losses], sum_ranks=True)[0])
                pred_depth = depth_images_from_outputs(inputs, pred, h, w)
                for i in range(pred_depth.shape[0]):
                    m = cleargrasp_metrics(pred_depth[i], batch["depth"][i],
                                           batch["corrupt_mask"][i])
                    if m:
                        bank.add(m)
                if self.is_main and vis_iter and it % vis_iter == 0:
                    from implicit_depth_torch.train.visualize import dump_batch_visuals
                    dump_batch_visuals(self.vis_dir, f"{split}_ep{epoch}_it{it}",
                                       batch, inputs, pred)
            results[split] = bank.means()
            if not self.is_main:
                continue
            line = f"epoch {epoch} split {split} " + " ".join(
                f"{k}={v:.4f}" for k, v in sorted(results[split].items()))
            with open(self.valid_log_path, "a") as f:
                f.write(line + "\n")
            print(line, flush=True)
        return results

    def test(self, split_loaders=None) -> None:
        """Per-image CSV ≙ train_lidf.py:625-664 / train_refine.py:625-664:
        one row per image whose mask is not empty, then the MEAN row."""
        cfg = self.cfg
        h, w = cfg.dataset.img_height, cfg.dataset.img_width
        loaders = split_loaders or self.make_valid_loaders()
        vis_iter = cfg.training.get("test_vis_iter", 0)
        for split, loader in loaders.items():
            rows = []
            for it, batch in enumerate(loader.epoch(0)):
                paths = batch["item_path"]
                inputs, pred, _ = self._eval(to_device(batch, self.device))
                if self.is_main and vis_iter and it % vis_iter == 0:
                    # ≙ test-time vis_cond2 (train_lidf.py:471-473)
                    from implicit_depth_torch.train.visualize import dump_batch_visuals
                    dump_batch_visuals(self.vis_dir, f"test_{split}_it{it}",
                                       batch, inputs, pred)
                pred_depth = depth_images_from_outputs(inputs, pred, h, w)
                for i in range(pred_depth.shape[0]):
                    m = cleargrasp_metrics(pred_depth[i], batch["depth"][i],
                                           batch["corrupt_mask"][i])
                    if m:
                        rows.append([paths[i], m["rmse"], m["abs_rel"], m["mae"],
                                     m["a1"], m["a2"], m["a3"]])
            if self.is_main and rows:
                path = osp.join(self.result_dir, f"{split}.csv")
                with open(path, "w", newline="") as f:
                    wcsv = csv.writer(f)
                    wcsv.writerow(_CSV_HEADER)
                    wcsv.writerows(rows)
                    arr = np.asarray([r[1:] for r in rows], np.float64)
                    wcsv.writerow(["MEAN", *arr.mean(0).tolist()])
                print(f"wrote {path} ({len(rows)} images)", flush=True)

    def run(self) -> None:
        cfg = self.cfg
        for epoch in range(self.start_epoch, cfg.training.nepochs):
            train_means = self.train_epoch(epoch)
            record = {"train": train_means}
            if self._should_validate(epoch):
                record["valid"] = self.validate(epoch)
            self._save_epoch(epoch, record)
            self._maybe_recycle(epoch)


class LIDFTrainer(BaseTrainer):
    """Stage 1 (≙ TrainLIDF)."""

    stage = "lidf"

    def __init__(self, cfg: Config, workdir: Optional[str] = None,
                 device: Device = "cuda"):
        super().__init__(cfg, workdir, device)
        # one model for training and eval: the eval step's rays are every
        # pixel whatever static.n_rays says
        self.static = build_static(cfg)
        self.model = build_lidf(cfg, self.static,
                                self._init_weights_generator()).to(self.device)
        self.train_loader = self.make_train_loader()
        self.steps_per_epoch = max(self.train_loader.steps_per_epoch(), 1)
        self.state = TrainState.create(self.model, cfg.training,
                                       self.steps_per_epoch)
        if not self._restore() and cfg.checkpoint_path:
            # load initial weights from an external run (≙ train_lidf.py:73-92)
            restore_params_only(cfg.checkpoint_path, self.model,
                                name=cfg.get("checkpoint_name", "latest_network"))
            print(f"loaded weights from {cfg.checkpoint_path}")
        self._replicate(self.model)
        self._log_setup()
        self.train_step = make_lidf_train_step(cfg, self.model, self.device)
        self.eval_step = make_lidf_eval_step(cfg, self.model, self.device)
        self._vis_step = None  # train-shape vis forward, built on first use

    def _make_vis_step(self):
        from implicit_depth_torch.train.steps import make_lidf_vis_step
        return make_lidf_vis_step(self.cfg, self.model, self.device)

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        def run_one(batch):
            return self.train_step(self.state, batch, self.generator, epoch)

        return self._run_train_epoch(epoch, run_one, "lidf", _LIDF_LOG_KEYS)

    def _eval(self, dev_batch):
        inputs, out, losses = self.eval_step(self.state, dev_batch,
                                             self.generator)
        return inputs, out["pred_pos"], losses


class RefineTrainer(BaseTrainer):
    """Stage 2 (≙ TrainRefine): frozen LIDF + refine net."""

    stage = "refine"

    def __init__(self, cfg: Config, workdir: Optional[str] = None,
                 device: Device = "cuda"):
        super().__init__(cfg, workdir, device)
        self.static = build_static(cfg)
        gen = self._init_weights_generator()
        self.lidf_model = build_lidf(cfg, self.static, gen)
        self.refine_model = build_refine(cfg, self.static, gen)
        # frozen stage-1 weights (train_refine.py:60-73)
        if cfg.lidf_ckpt_path:
            restore_params_only(cfg.lidf_ckpt_path, self.lidf_model,
                                name=cfg.get("lidf_ckpt_name", "latest_network"))
        self.lidf_model.to(self.device)
        self.refine_model.to(self.device)

        self.train_loader = self.make_train_loader()
        self.steps_per_epoch = max(self.train_loader.steps_per_epoch(), 1)
        self.state = TrainState.create(self.refine_model, cfg.training,
                                       self.steps_per_epoch)
        if not self._restore() and cfg.checkpoint_path:
            restore_params_only(cfg.checkpoint_path, self.refine_model,
                                name=cfg.get("checkpoint_name", "latest_network"))
            print(f"loaded refine weights from {cfg.checkpoint_path}")
        self._replicate(self.refine_model, self.lidf_model)
        self._log_setup()
        self.train_step = make_refine_train_step(cfg, self.lidf_model,
                                                 self.refine_model, self.device)
        self.eval_step = make_refine_eval_step(cfg, self.lidf_model,
                                               self.refine_model, self.device)
        self._vis_step = None

    def _make_vis_step(self):
        from implicit_depth_torch.train.steps import make_refine_vis_step
        return make_refine_vis_step(self.cfg, self.lidf_model,
                                    self.refine_model, self.device)

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        def run_one(batch):
            return self.train_step(self.state, batch, self.generator, epoch)

        return self._run_train_epoch(epoch, run_one, "refine", _REFINE_LOG_KEYS)

    def _eval(self, dev_batch):
        inputs, _, pred, losses = self.eval_step(self.state, dev_batch,
                                                 self.generator)
        return inputs, pred, losses


TRAINERS = {"lidf": LIDFTrainer, "refine": RefineTrainer}
