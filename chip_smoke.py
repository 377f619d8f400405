"""Chip smoke test of the PyTorch/CUDA port (``implicit_depth_torch``) on one
NVIDIA GPU: builds the CUDA kernels, holds each against its plain PyTorch
version at the shapes of its main path, serves synthetic frames through the
port's two-stage ``DepthCompleter`` (in the default per_ray decode mode and
in the ``global`` and dense modes), trains stage 1 for a few steps (in
every ``decode_bwd`` mode: ``kernel_save``, ``kernel``, ``kernel_save_all``
and ``xla``) and stage 2 behind a frozen stage 1, all at the full default
width, cross-checks frames and train steps against the plain CPU path, and
serves and resumes from checkpoints.

    python3 chip_smoke.py             # every phase; exits 0 only if all pass
    python3 chip_smoke.py --profile   # also torch.profiler tables of a frame
                                      # and of a train step in each
                                      # decode_bwd mode and of a stage-2
                                      # step, with its device time

Phases:
  1. device: a CUDA device must be present; prints name and power limit;
  2. build: nvcc builds csrc/*.cu (into build/idt_torch_kernels/);
  3. kernels: K1 ray_decode, K4 ief_decode, K5 segment_max0 on the inputs the
     main path gives them (recorded from a warm-up frame), in bf16 and f32:
     max |kernel - plain| against a stated tolerance that lies well below
     the spread of the outputs (the weights are redrawn at unit activation
     scale), and median times of the kernel, its plain version and (K5) the
     library yardstick; for K5 also the bare kernel's device time and the
     yardstick's (torch.profiler, 100 calls) and every device operation a
     call puts on the stream;
  4. main path: 5 frames of 480x640 through DepthCompleter.complete on the
     card (launch counters from 0: K1 1, K4 2, K5 10 per frame), finite output,
     input depth passed through bit for bit; median ms per frame;
  5. cross-check: one frame in f32 on the card (kernels) and on the CPU
     (plain versions), same weights and valid-point draw;
  6. training path: 5 timed Adam steps (after a warm-up step) of the
     default stage-1 model at 240x320, 20,000 rays and 10,000 valid points
     per image, batch 4, bf16 (launch counters from 0: K2 1, K3 1, K5 2 per
     step), finite losses, every parameter moved; median step_ms, peak
     memory;
  7. training kernels, on the inputs the warm-up step gave them (recorded),
     in bf16 and f32, against their plain versions: K2 ray_decode_save's
     outputs and saves; K3 ray_decode_bwd's d_vox_table, d_ray_feat and
     every weight gradient; K5 segment_max0's forward and its gradient
     (exact); times and bounds; K3's passes (device ms of Pass A, Pass B and
     the final reduction from CUDA events the C function records between
     its launches) and its scratch;
  8. training cross-check: one f32 train step on the card and on the CPU
     (a smaller frame), same weights and draws, for three seeds: losses and
     each parameter's gradient; for the first seed also the card with
     cuDNN deterministic and with cuDNN off, logged;
  9. the ``global`` (budget 8) and dense (``pairs_budget_per_ray`` 0) decode
     modes, each: K6 pair_decode against its plain version on the inputs
     recorded from a warm-up frame, in bf16 and f32, with times and bound
     (in ``global`` over the rows below the frame's row count, which K6
     alone decodes: every row past it must be exactly 0 and every row below
     it the bits of the call without the count, whose time and bound are
     logged too); K6's ptxas registers and spills from the build;
     MODE_FRAMES frames of 480x640 served (launch counters from 0: K6 1, K1
     0, K4 2, K5 10 per frame), input depth bit for bit, median ms per
     frame, the valid pairs per frame and the pairs the budget dropped; an
     f32 frame at 120x160 on the card and on the CPU (as phase 5), the
     ``global`` one at budget 1, which must drop pairs;
 10. training with ``decode_bwd: kernel``: TRAIN_STEPS Adam steps as in
     phase 6 (launch counters from 0: K1 1, K3 1, K2 0, K5 2 per step); on
     the recorded inputs, in bf16 and f32, K1 against ``ray_decode_plain``
     at K2's output tolerances and K3's recompute instance against
     ``ray_decode_bwd_plain(saved=None)`` at K3's, with times, passes and
     bounds;
 11. training with ``decode_bwd: kernel_save_all``: TRAIN_STEPS Adam steps
     (launch counters from 0: K2 'all' 1, K3 1, K1 0, K2 0, K5 2 per step);
     on the recorded inputs, in bf16 and f32, K2 'all' against
     ``ray_decode_plain(saves='all')`` (outputs, the f32 offsets and logit
     at K2's output tolerances, every other save within an ulp of its
     largest value, the first offset exact) and K3 from full saves against
     ``ray_decode_bwd_plain(saved=<those saves>)`` at K3's, with times,
     passes, scratch and bounds;
 12. training with ``decode_bwd: xla``: TRAIN_STEPS Adam steps (launch
     counters from 0: K1 1, K2 0, K2 'all' 0, K3 0, K5 2 per step; the
     backward is autograd through the plain decode, as the JAX package's
     'xla' mode is XLA autograd); the step medians of all four
     ``decode_bwd`` modes of this run;
 13. stage-2 training: TRAIN_STEPS Adam steps of the refine network
     (configs/train_refine.yaml's settings: forward_times 2, perturbation
     0.8, lr 1e-3, pos_w 100, surf_norm_w 10) behind the frozen per_ray
     stage 1, batch 4 at 240x320, 20,000 rays and 10,000 valid points per
     image, bf16 (launch counters from 0: K1 1, K4 2, K5 10, K2 0, K3 0, K6
     0 per step), finite losses, every refine parameter moved, every stage-1
     parameter and buffer bit for bit as before; median step_ms, peak
     memory; on the inputs the warm-up step gave K4's training entry and
     the refine network's K5 calls (recorded), in bf16 and f32: K4 against
     ``ief_decode_plain`` (phase 3's tolerances), the training decode's
     gradients (K4 forward, autograd of the plain decode recomputed)
     against autograd of ``ief_decode_plain`` on the same inputs, whether
     they are the same bits, and the backward's time; K5 and its gradient
     exact, as phase 7;
 14. stage 2 with hard negatives (configs/train_refine_hardneg.yaml: ratio
     0.1, pos_w 20, lr 1e-4): HARDNEG_STEPS steps, finite, the same launch
     counts;
 15. the refine eval step on one 240x320 image, every pixel a ray,
     ``use_all_pix`` false, in f32 on the card (K1 1, K4 2, K5 10) and on
     the CPU, same weights and valid points: as phase 5;
 16. one f32 refine step on the card and on the CPU (phase 8's frame),
     same weights and draws, for three seeds: losses and each refine
     parameter's gradient;
 17. checkpoints: phase 13's stage 1 and refine state saved;
     ``DepthCompleter.from_checkpoint`` serves a 480x640 frame bit for bit
     as the in-memory pair; the refine state restored into fresh models
     takes one more step bit for bit as the uninterrupted state does.
The next-to-last line is {"kernels": [...]}; the last is
{"ok": true, "device": {...}}. Any failure raises: no phase is caught.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

MAIN_FRAMES = 5
FRAME_HW = (480, 640)
SEED = 0
# the full default model; every pixel of a frame is a ray
SERVE_OVERRIDES = {"mask_type": "all"}
EXPECT_PER_FRAME = {"ray_decode": 1, "ief_decode": 2, "segment_max0": 10}
# the global and dense decode modes: K6 in place of K1
MODES = {"global": {"pairs_budget_mode": "global", "pairs_budget_per_ray": 8},
         "dense": {"pairs_budget_per_ray": 0}}
MODE_FRAMES = 3
EXPECT_PER_MODE_FRAME = {"pair_decode": 1, "ray_decode": 0, "ief_decode": 2,
                         "segment_max0": 10}
# a dense f32 decode on the CPU at 240x320 is 1.5 M rows: cross-check the
# modes at a quarter of the pixels
MODE_XCHECK_DATASET = {"img_height": 120, "img_width": 160}
# the served frames hold 2.3-3.4 valid pairs per ray, so budget 8 drops none:
# the global cross-check runs at budget 1, which must drop pairs, so that the
# spill slot and the per-ray competition over `pair_valid & decoded` run on
# the card too
MODE_XCHECK_TPU = {"global": {"pairs_budget_per_ray": 1}, "dense": {}}
# H100 SXM peaks: dense bf16 tensor cores, f32 on the CUDA cores, HBM3
PEAK_TC = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_CUDA_CORES = 67e12
PEAK_BYTES = 3.35e12
# kernel vs plain version on the same inputs, with the weights of
# builder.randomize_weights_ (decoder outputs of 0.3-0.6 with a spread of
# 0.05-0.1 at the serving shapes): f32 — the same f32 algebra in another
# summation order (measured ~2e-7 on an H100); bf16 — the summation order
# can move the bf16 rounding of a hidden activation by one ulp (2^-8 of it),
# which moved outputs by up to ~2e-3 on an H100: the tolerance is twice
# that; K5 — a max is exact in any order
TOL = {("ray_decode", torch.float32): 1e-5, ("ray_decode", torch.bfloat16): 4e-3,
       ("pair_decode", torch.float32): 1e-5, ("pair_decode", torch.bfloat16): 4e-3,
       ("ief_decode", torch.float32): 1e-5, ("ief_decode", torch.bfloat16): 4e-3,
       ("segment_max0", torch.float32): 0.0, ("segment_max0", torch.bfloat16): 0.0}
# a tolerance must be this many times smaller than the spread (standard
# deviation) of the outputs it compares, or the comparison could not tell a
# right kernel from one that drops an iteration or a layer
BITE = 10
# cross-check (f32, card kernels vs CPU plain, same weights): a pixel agrees
# when |depth difference| <= 1e-3 m; up to 1% may differ, because a 1e-6
# difference can still move a predicted point across a voxel boundary (the
# refine then pools and decodes another cell) or flip a near-tie slot
XCHECK_ATOL, XCHECK_FRAC = 1e-3, 0.01
# training: the default model and sizes (240x320, 20,000 rays and 10,000
# valid points per image); the configured batch_size 32 is cut to the JAX
# bench's training batch 4 (640,000 decoded pairs per step)
TRAIN_OVERRIDES = {}
TRAIN_BATCH, TRAIN_STEPS = 4, 5
EXPECT_PER_STEP = {"ray_decode_save": 1, "ray_decode_bwd": 1,
                   "segment_max0": 2}
# decode_bwd 'kernel': K1's save-free forward, K3 recomputing layer 1
EXPECT_PER_STEP_KERNEL = {"ray_decode": 1, "ray_decode_save": 0,
                          "ray_decode_bwd": 1, "segment_max0": 2}
# decode_bwd 'kernel_save_all': K2 'all', K3 from its full saves
EXPECT_PER_STEP_SAVE_ALL = {"ray_decode_save_all": 1, "ray_decode_bwd": 1,
                            "ray_decode": 0, "ray_decode_save": 0,
                            "segment_max0": 2}
# decode_bwd 'xla': K1, then autograd through the plain decode (no K3)
EXPECT_PER_STEP_XLA = {"ray_decode": 1, "ray_decode_save": 0,
                       "ray_decode_save_all": 0, "ray_decode_bwd": 0,
                       "segment_max0": 2}
# the training kernels against their plain versions. K2's outputs: f32
# 1e-5 as K1's; bf16 1e-3 (2.5x the 4e-4 measured on an H100 at these
# shapes: the training model's decoder outputs spread less than the served
# ones, std ~0.026, and K1's 4e-3 would not bite); its saves, rounded to
# the compute type from sums taken in another order, may differ by an ulp
# of each value: f32 1e-5, bf16 2^-7 of the largest value. K3 per
# gradient, by the norm of the difference over the norm of the plain
# gradient: f32 1e-4 (one algebra, another order); bf16 2e-2 (the kernel
# rounds each cotangent to bf16 before its product, as the JAX kernel does;
# the plain autograd does not)
TRAIN_TOL = {("ray_decode_save_out", torch.float32): 1e-5,
             ("ray_decode_save_out", torch.bfloat16): 1e-3,
             ("ray_decode_save", torch.float32): 1e-5,
             ("ray_decode_save", torch.bfloat16): 2.0 ** -7,
             ("ray_decode_bwd", torch.float32): 1e-4,
             ("ray_decode_bwd", torch.bfloat16): 2e-2,
             ("ray_decode_bwd_recompute", torch.float32): 1e-4,
             ("ray_decode_bwd_recompute", torch.bfloat16): 2e-2,
             ("ray_decode_bwd_all", torch.float32): 1e-4,
             ("ray_decode_bwd_all", torch.bfloat16): 2e-2}
# train-step cross-check (f32, card vs CPU, same weights and draws, the
# curriculum's labelled slot so that no near-tie picks another slot), per
# seed: the largest relative difference of a loss, and of a parameter's
# gradient in each group. Readings on an H100 for seeds 0/1/2: losses
# 9.9e-7/3.7e-6/7.0e-7; decoders and PointNet (the port's kernels, the K5
# gradient) 5.4e-4/1.2e-3/1.1e-3; ResNet 3.2e-3/1.3e-2/7.3e-3. Summation
# order alone moves them that far: the same card with cuDNN off (PyTorch's
# own convolutions) moved seed 0's ResNet gradients by 3.4e-3 and a decoder
# bias's by 2.5e-3 from its cuDNN run (the backward through 33 convolutions
# and train-mode batch norms amplifies a 1e-5 difference of the feature
# map). Limits: 1e-4, 5e-3 and 4e-2, 3-4x above the largest reading and
# at least 2x above the cuDNN-off distance; a decoder gradient 1% off
# still fails
XCHECK_TRAIN = {"dataset": {"img_height": 120, "img_width": 160},
                "grid": {"miss_sample_num": 2000, "valid_sample_num": 2000},
                "tpu": {"compute_dtype": "float32"}}
XCHECK_SEEDS = (0, 1, 2)
XCHECK_LOSS_RTOL, XCHECK_GRAD_RTOL, XCHECK_RESNET_RTOL = 1e-4, 5e-3, 4e-2
# stage-2 training: the settings of configs/train_refine.yaml that the port
# reads, copied so that the smoke needs no pyyaml
# (tests/test_torch_port_refine_train holds them against the file), the
# default widths, 240x320 at 20,000 rays and 10,000 valid points per image,
# bf16; the configured batch_size 32 cut to 4, as for stage 1
REFINE_OVERRIDES = {"mask_type": "all", "model": {"maxpool_label_epo": 0},
                    "refine": {"forward_times": 2, "perturb": True,
                               "perturb_prob": 0.8,
                               "offset_range": [-0.2, 0.2]},
                    "training": {"batch_size": 32, "nepochs": 30,
                                 "nepoch_decay": 30, "lr": 0.001},
                    "loss": {"pos_w": 100.0, "prob_w": 0,
                             "surf_norm_w": 10.0},
                    "tpu": {"max_pairs_per_ray": 20,
                            "compute_dtype": "bfloat16"}}
# configs/train_refine_hardneg.yaml: hard negatives (ratio 0.1), pos_w 20,
# lr 1e-4
REFINE_HARDNEG_OVERRIDES = {
    **REFINE_OVERRIDES,
    "training": {"batch_size": 32, "nepochs": 30, "lr": 0.0001},
    "loss": {"hard_neg": True, "hard_neg_ratio": 0.1, "pos_w": 20.0,
             "prob_w": 0, "surf_norm_w": 10.0}}
HARDNEG_STEPS = 2
# per stage-2 step: the frozen stage 1's serving K1 (no graph), two refine
# iterations each decoding through K4 and pooling through K5 4 times (2
# parts x 2 pools), stage 1's 2 K5 pools; no stage-1 training kernel
EXPECT_PER_REFINE_STEP = {"ray_decode": 1, "ief_decode": 2,
                          "segment_max0": 10, "ray_decode_save": 0,
                          "ray_decode_save_all": 0, "ray_decode_bwd": 0,
                          "pair_decode": 0}
# the training IEF decode's backward (autograd of the plain decode,
# recomputed) against autograd of the plain decode on the same inputs: the
# same computation, expected bit for bit; held to K3's tolerances
REFINE_GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# the f32 refine step cross-check (card vs CPU, same weights and draws):
# phase 8's frame and limits (losses 1e-4, decoder and PointNet gradients
# 5e-3)
REFINE_XCHECK = {**REFINE_OVERRIDES, **XCHECK_TRAIN,
                 "tpu": {"max_pairs_per_ray": 20, "compute_dtype": "float32"}}
SOURCES = {"ray_decode": ("implicit_depth_torch/csrc/ray_decode.cu",
                          "implicit_depth_tpu/ops/pallas_ray_decode.py:357"),
           "ray_decode_save": ("implicit_depth_torch/csrc/ray_decode.cu",
                               "implicit_depth_tpu/ops/pallas_ray_decode.py:650"),
           "ray_decode_bwd": ("implicit_depth_torch/csrc/ray_decode_bwd.cu",
                              "implicit_depth_tpu/ops/pallas_ray_decode.py:931"),
           "ray_decode_bwd_recompute": (
               "implicit_depth_torch/csrc/ray_decode_bwd.cu",
               "implicit_depth_tpu/ops/pallas_ray_decode.py:931"),
           # fused_ray_decode_table's forward rule with save_mode='all'
           # (_table_fwd), and _fused_bwd_impl's save_mode == "all" branch
           "ray_decode_save_all": (
               "implicit_depth_torch/csrc/ray_decode.cu",
               "implicit_depth_tpu/ops/pallas_ray_decode.py:650"),
           "ray_decode_bwd_all": (
               "implicit_depth_torch/csrc/ray_decode_bwd.cu",
               "implicit_depth_tpu/ops/pallas_ray_decode.py:931"),
           "pair_decode": ("implicit_depth_torch/csrc/pair_decode.cu",
                           "implicit_depth_tpu/ops/pallas_decode.py:111"),
           "ief_decode": ("implicit_depth_torch/csrc/ief_decode.cu",
                          "implicit_depth_tpu/ops/pallas_ray_decode.py:821"),
           "segment_max0": ("implicit_depth_torch/csrc/segment_max.cu",
                            "implicit_depth_tpu/ops/pallas_segment.py:63")}


def log(*a):
    print(*a, flush=True)


def time_ms(fn, warmup=2, reps=10):
    """Median of ``reps`` single-call CUDA-event times after ``warmup``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, match, reps=100):
    """(mean device ms per call of the kernels whose name holds ``match``,
    {device operation: (ms, count) per call}) over ``reps`` calls of ``fn``
    (torch.profiler, after one warm-up call); (None, {}) where the profiler
    sees no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total, ops = 0.0, {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = ev.cuda_time_total
        if t <= 0 or str(getattr(ev, "device_type", "")).endswith("CPU"):
            continue
        ops[ev.key[:80]] = (t / reps / 1e3, ev.count / reps)
        if match in ev.key:
            total += t
    return (total / reps / 1e3 if total else None), ops


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if torch.is_tensor(t))


def rel_norm(got, ref, floor=0.0):
    """|got - ref| / max(|ref|, floor) over the whole tensor. ``floor``
    serves a gradient that is a sum which cancels, as the gradient of a
    decoder's last bias (the sum of its output's cotangents; the softmax
    cross-entropy's sum to ~0 over each ray's slots): it is then measured
    against the sum of the magnitudes it adds up."""
    got, ref = got.double(), ref.double()
    return ((got - ref).norm() / ref.norm().clamp(min=max(floor, 1e-30))).item()


def bound(name, a, dt, n_iter=2, rows=None):
    """(bound_ms, bound_by, flops, bytes) of one call on these inputs (and
    ``n_iter`` IEF iterations): each input read once, each output written
    once, the operations at the peak rate of the units that do them. K6:
    ``rows`` rows decoded (default all), whose cells, rays and positions are
    read; every row's outputs written."""
    if name in ("ray_decode", "ray_decode_save", "ray_decode_save_all"):
        vt, cells, pos, rf, w = a
        n, kb = cells.shape
        c_vox, c_ray, multires = w["dims"]
        g1, g2, g3 = 256, 128, 64
        tail = g1 * g2 + g2 * g3 + g3
        # per pair: layer 1 over [vox | pos6 | trig] for both decoders, then
        # three tails (2 IEF iterations + the prob decoder); per ray: the
        # [roi | dir_e] part of layer 1
        flops = 2 * (n * kb * ((c_vox + 6 + 12 * multires) * 2 * g1 + 3 * tail)
                     + n * c_ray * 2 * g1)
        byt = nbytes(vt, cells, pos, rf, *w.values()) + 2 * n * kb * 4
        if name != "ray_decode":  # e1, z1p, trig written
            byt += n * kb * (2 * g1 + 12 * multires) * vt.element_size()
        if name == "ray_decode_save_all":
            # and per IEF iteration and the probability decoder h2, h3; the
            # offsets entering each iteration, the final one, the logit (f32)
            byt += n * kb * ((n_iter + 1) * (g2 + g3) * vt.element_size()
                             + (n_iter + 2) * 4)
        peak = PEAK_TC[dt]
    elif name == "pair_decode":
        vt, cells, pos, rf, w, rays = a
        p = cells.shape[0]
        rows = p if rows is None else rows
        c_vox, c_roi, c_dir, multires = w["dims"]
        c_embed = c_vox + c_roi + 6 * (1 + 2 * multires) + c_dir
        tail = 256 * 128 + 128 * 64 + 64
        # per row decoded: layer 1 of both decoders over the whole embedding
        # (the IEF's once), two IEF tails and the probability tail
        flops = 2 * rows * (c_embed * 2 * 256 + 3 * tail)
        per_row = nbytes(cells, pos, rays) / max(p, 1)
        byt = nbytes(vt, rf, *w.values()) + rows * per_row + 2 * p * 4
        peak = PEAK_TC[dt]
    elif name in ("ray_decode_bwd", "ray_decode_bwd_recompute",
                  "ray_decode_bwd_all"):
        vt, cells, pos, rf, w, saved, g_off, g_logit = a
        n, kb = cells.shape
        c_vox, c_ray, multires = w["dims"]
        g1, g2, g3 = 256, 128, 64
        tail = g1 * g2 + g2 * g3 + g3
        c_pair = c_vox + 6 + 12 * multires
        # per pair, from the saved layer-1 pre-activations: the three tails
        # recomputed (2 IEF iterations + the prob decoder) and differentiated
        # (input and weight gradients: 2 products each), layer 1's weight
        # gradient over [vox | pos6 | trig] and d(voxel row), for both
        # decoders; per ray: the [roi | dir_e] weight gradient and d_ray_feat
        flops = 2 * (n * kb * (3 * tail + 3 * 2 * tail + c_pair * 2 * g1
                               + c_vox * 2 * g1)
                     + n * c_ray * 2 * g1 * 2)
        if name == "ray_decode_bwd_all":  # from full saves: no forward tail
            flops -= 2 * n * kb * 3 * tail
        if saved is None:  # recompute: both layer-1 products, per pair and ray
            flops += 2 * (n * kb * c_pair * 2 * g1 + n * c_ray * 2 * g1)
        byt = (nbytes(vt, cells, pos, rf, *w.values(), *(saved or ()), g_off,
                      g_logit)
               + vt.numel() * 4 + n * c_ray * 4          # d_table, d_ray_feat
               + sum(w[k].numel() * 4 for k in w if k != "dims"))
        peak = PEAK_TC[dt]
    elif name == "ief_decode":
        e, rc, p, w = a
        n = e.shape[0]
        flops = 2 * n * ((e.shape[1] + rc.shape[1] + p.shape[1]) * 256
                         + 2 * (256 * 128 + 128 * 64 + 64))
        byt = nbytes(e, rc, p, *w.values()) + n * 4
        peak = PEAK_TC[dt]
    elif name == "segment_max0_bwd":
        # per element: the tie compare, its count, the share's division and
        # product; reads data, ids, valid, the pooled output and its
        # cotangent, writes d data
        d, ids, ns, v, out, g = a
        flops = 4 * d.numel()
        byt = nbytes(d, ids, v, out, g) + d.numel() * d.element_size()
        peak = PEAK_CUDA_CORES
    else:
        d, ids, ns, v = a
        flops = d.numel()  # one compare per element
        byt = nbytes(d, ids, v) + ns * d.shape[1] * d.element_size()
        peak = PEAK_CUDA_CORES
    t_ops, t_bytes = flops / peak, byt / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, byt)


def build_phase():
    from implicit_depth_torch.ops import cuda
    cuda.build_all()
    log(f"build_s {cuda.build_seconds:.2f}")
    for line in cuda.build_log.splitlines():
        if any(k in line for k in ("Compiling entry", "registers", "spill",
                                   "error")):
            log("  nvcc:", line.strip())


def make_frames(n, hw):
    from implicit_depth_torch.data.synthetic import synthetic_scene_raw
    rng = np.random.default_rng(SEED)
    frames = []
    for _ in range(n):
        s = synthetic_scene_raw(rng, *hw)
        # depth is missing on the transparent object (whose visible part may
        # be empty) and at 5% scattered sensor holes
        missing = s["object_masks"][0] | (rng.random(hw) < 0.05)
        depth = np.where(missing, 0.0, s["depth"]).astype(np.float32)
        frames.append((s["rgb_u8"], depth, (s["fx"], s["fy"], s["cx"], s["cy"])))
    return frames


def kernel_modules():
    """(module, attribute) of each kernel wrapper as the serving paths call
    it."""
    from implicit_depth_torch.models import lidf, pointnet, refine
    return {"ray_decode": (lidf, "ray_decode"), "ief_decode": (refine, "ief_decode"),
            "segment_max0": (pointnet, "segment_max0"),
            "pair_decode": (lidf, "pair_decode")}


def counters():
    """Each kernel wrapper, which counts its launches in ``.launches``."""
    from implicit_depth_torch.ops import pair_decode as pd
    from implicit_depth_torch.ops import ray_decode as rd
    from implicit_depth_torch.ops import segment
    return {"ray_decode": rd.ray_decode, "ray_decode_save": rd.ray_decode_save,
            "ray_decode_save_all": rd.ray_decode_save_all,
            "ray_decode_bwd": rd.ray_decode_bwd, "ief_decode": rd.ief_decode,
            "segment_max0": segment.segment_max0,
            "pair_decode": pd.pair_decode}


def record_calls(mods, run, when=None, keep=None):
    """``run()`` with each kernel wrapper of ``mods`` ({name: (module,
    attribute)}) replaced by a recorder; returns {(name, shapes): (args,
    kwargs)} of each wrapper's first call per input shape (among the calls
    ``when(args)`` accepts; stored as ``keep(args)`` gives them)."""
    recorded = {}
    originals = {name: getattr(m, attr) for name, (m, attr) in mods.items()}

    def recorder(name):
        def call(*a, **kw):
            shape = tuple(tuple(t.shape) for t in a if torch.is_tensor(t))
            if (name, shape) not in recorded and (when is None or when(a)):
                recorded[(name, shape)] = (keep(a) if keep else a, kw)
            return originals[name](*a, **kw)
        # a wrapper that counts through its own module's global name counts
        # on this recorder while it stands in there
        call.launches = 0
        return call

    for name, (m, attr) in mods.items():
        setattr(m, attr, recorder(name))
    try:
        run()
    finally:
        for name, (m, attr) in mods.items():
            setattr(m, attr, originals[name])
    torch.cuda.synchronize()
    return recorded


@torch.inference_mode()
def kernel_phase(recorded, lidf, refine, dev):
    """Each recorded call of a served frame, kernel vs plain (see
    ``forward_rows``). Returns the row of each kernel at its largest bf16
    shape."""
    from implicit_depth_torch.models.lidf import decoder_weights
    from implicit_depth_torch.ops import ray_decode as rd

    f32w_k1 = rd.prep_ray_decode_weights(
        decoder_weights(lidf.offset_dec, lidf.prob_dec), lidf.dims["c_vox"],
        lidf.dims["c_roi"], lidf.dims["c_dir"], lidf.multires, torch.float32)
    f32w_k4 = rd.prep_ief_weights(
        refine.offset_dec.decode_weights(), refine.dims["c_end"],
        refine.dims["c_rc"], refine.dims["c_pos"], refine.dims["c_dir"],
        torch.float32)

    def as_f32(name, a):
        """The recorded bf16 call's operands in f32 (weights re-prepared)."""
        if name == "ray_decode":
            vt, cells, pos, rf, _ = a
            return vt.float(), cells, pos, rf.float(), f32w_k1
        if name == "ief_decode":
            e, rc, p, _ = a
            return e.float(), rc.float(), p.float(), f32w_k4
        return segment_as_f32(name, a)

    rows = forward_rows(recorded, as_f32, dev)
    if set(rows) != set(EXPECT_PER_FRAME):
        raise AssertionError(f"kernels measured: {sorted(rows)}")
    return rows


def segment_as_f32(name, a):
    """A recorded K5 call's operands with the data in f32."""
    d, ids, ns, v = a
    return d.detach().float(), ids, ns, v


def forward_rows(recorded, as_f32, dev, tols=TOL):
    """Each recorded call ({(name, shapes): (args, kwargs)}) in bf16 (as
    recorded) and f32 (``as_f32(name, args)``): max |kernel - plain| against
    ``tols``, which must lie BITE times below the outputs' spread; times;
    bound. Returns the row of each kernel at its largest bf16 shape."""
    from implicit_depth_torch.ops import pair_decode as pd
    from implicit_depth_torch.ops import ray_decode as rd
    from implicit_depth_torch.ops import segment

    mods = kernel_modules()
    by_shape = {}
    plain = {"ray_decode": rd.ray_decode_plain, "ief_decode": rd.ief_decode_plain,
             "segment_max0": segment.segment_max0_plain,
             "pair_decode": pd.pair_decode_plain}
    entries = {}
    for (name, shape), (a0, kw) in sorted(recorded.items()):
        kern = getattr(*mods[name])
        for dt in (torch.bfloat16, torch.float32):
            a = a0 if dt == torch.bfloat16 else as_f32(name, a0)
            got, ref = kern(*a, **kw), plain[name](*a, **kw)
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            ref = ref if isinstance(ref, tuple) else (ref,)
            err = max((g.float() - r.float()).abs().max().item()
                      for g, r in zip(got, ref))
            # typical size and least spread of the outputs compared
            typical = max(r.float().abs().mean().item() for r in ref)
            spread = min(r.float().std().item() for r in ref)
            tol = tols[(name, dt)]
            ok = err <= tol and all(torch.isfinite(g).all() for g in got)
            ms = time_ms(lambda: kern(*a, **kw))
            plain_ms = time_ms(lambda: plain[name](*a, **kw))
            lib_ms, extra = None, {}
            rows = None
            if kw.get("n_rows") is not None:  # K6 in the global mode
                rows, extra = count_checks(name, dt, kern, a, kw, got, ms)
            if name == "segment_max0":  # yardstick: one PyTorch scatter call
                d, ids, ns, v = a
                src = torch.where(v[:, None], d, torch.zeros((), dtype=d.dtype,
                                                             device=dev))
                idx = ids.long()[:, None].expand_as(d)
                # a max into a zero table is idempotent: every repeat does
                # the same work as the first
                table = torch.zeros((ns, d.shape[1]), dtype=d.dtype, device=dev)
                lib_ms = time_ms(lambda: table.scatter_reduce_(0, idx, src,
                                                               "amax"))
                # device times: the bare kernel (of 100 wrapper calls), what
                # else each call puts on the stream, and the yardstick's
                extra["kernel_device_ms"], extra["device_ops_per_call"] = \
                    device_ms(lambda: kern(*a, **kw), "segment_max")
                extra["library_device_ms"], _ = device_ms(
                    lambda: table.scatter_reduce_(0, idx, src, "amax"),
                    "scatter")
            b_ms, b_by, flops, byt = bound(name, a, dt, rows=rows)
            row = {"name": name, "dtype": str(dt).split(".")[-1],
                   "shape": [list(s) for s in shape], "max_abs_err": err,
                   "tolerance": tol, "typical_abs": typical,
                   "spread": spread, "ms": ms, "plain_ms": plain_ms,
                   "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
                   "flops": flops, "bytes": byt, **extra}
            log(f"kernel {name} {row['dtype']} {row['shape']}: "
                f"max_abs_err {err:.3g} (tol {tol}; outputs: mean |y| "
                f"{typical:.3g}, std {spread:.3g}) ms {ms:.4f} "
                f"plain_ms {plain_ms:.4f} library_ms {lib_ms} "
                f"bound_ms {b_ms:.4f} ({b_by})"
                + "".join(f" {k} {v}" for k, v in extra.items()))
            if not ok:
                raise AssertionError(f"{name} {dt}: kernel disagrees with its "
                                     f"plain version: {err} > {tol}")
            if BITE * tol > spread:
                raise AssertionError(f"{name} {dt}: tolerance {tol} is not "
                                     f"{BITE}x below the outputs' spread "
                                     f"{spread}")
            if name == "segment_max0":  # every shape's times, for the record
                by_shape.setdefault(name, []).append(
                    {k: row[k] for k in ("shape", "dtype", "ms", "library_ms",
                                         "kernel_device_ms",
                                         "library_device_ms")})
            # the JSON line carries the main path's dtype at its largest shape
            if dt == torch.bfloat16:
                size = shape[0][0] * (shape[0][1] if len(shape[0]) > 1 else 1)
                if name not in entries or size >= entries[name][0]:
                    entries[name] = (size, row)
    rows = {name: row for name, (_, row) in entries.items()}
    for name, shapes in by_shape.items():
        rows[name]["by_shape"] = shapes
    return rows


def count_checks(name, dt, kern, a, kw, got, ms):
    """K6 called with its row count (the global mode's valid prefix): every
    output row at or past the count exactly 0, and the rows below it the
    bits of the same call without the count (which decodes every row).
    Returns (rows decoded, the row's extra entries: rows_decoded, and the
    time and bound of the call without the count)."""
    rows = int(kw["n_rows"].item())
    p = got[0].shape[0]
    kw_all = {k: v for k, v in kw.items() if k != "n_rows"}
    full = kern(*a, **kw_all)
    torch.cuda.synchronize()
    for g, f in zip(got, full):
        if (g[rows:] != 0).any():
            raise AssertionError(f"{name} {dt}: rows at or past n_rows={rows} "
                                 "are not 0")
        if not torch.equal(g[:rows], f[:rows]):
            raise AssertionError(f"{name} {dt}: the rows below n_rows differ "
                                 "from the call without it")
    ms_all = time_ms(lambda: kern(*a, **kw_all))
    b_all = bound(name, a, dt)[0]
    log(f"kernel {name} {str(dt).split('.')[-1]}: {rows} of {p} rows "
        f"decoded: ms {ms:.4f}; every row: ms {ms_all:.4f} bound_ms "
        f"{b_all:.4f}")
    return rows, {"rows_decoded": rows, "rows": p, "ms_all_rows": ms_all,
                  "bound_ms_all_rows": b_all}


def ptxas_of(source, match):
    """{entry function: {registers, spill_stores, spill_loads}} of the
    entries of ``source`` (e.g. "pair_decode.cu") whose mangled name holds
    ``match``, from this process's build log (nvcc -Xptxas -v); {} when the
    kernels were built before this process."""
    from implicit_depth_torch.ops import cuda
    out, entry, section = {}, None, None
    for line in cuda.build_log.splitlines():
        if line.startswith("== "):
            section = line[3:].strip()
        elif section != source:
            continue
        elif "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif entry and match in entry and "spill stores" in line:
            f = line.split()
            out.setdefault(entry, {}).update(
                spill_stores=int(f[f.index("spill") - 2]),
                spill_loads=int(f[-4]))
        elif entry and match in entry and "registers" in line:
            f = line.replace(",", " ").split()
            out.setdefault(entry, {})["registers"] = int(f[f.index("registers") - 1])
    return out


def main_path(dc, frames, cfg, expect=EXPECT_PER_FRAME, label="main path"):
    """Serve ``frames`` with the launch counters of ``expect`` from 0;
    returns the launches and the median ms per frame."""
    counts = {k: f for k, f in counters().items() if k in expect}
    for f in counts.values():
        f.launches = 0
    frame_ms = []
    for rgb, depth, intr in frames:
        t0 = time.perf_counter()
        out = dc.complete(rgb, depth, intr)
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        assert out["depth"].shape == depth.shape, out["depth"].shape
        assert out["depth_pred"].shape == (cfg.dataset.img_height,
                                           cfg.dataset.img_width)
        assert np.isfinite(out["depth"]).all() and np.isfinite(out["depth_pred"]).all()
        have = depth != 0
        assert have.any() and (~have).any()
        assert out["depth"][have].tobytes() == depth[have].tobytes(), \
            "input depth not passed through bit for bit"
    launches = {k: f.launches for k, f in counts.items()}
    log(f"{label}: {len(frames)} frames {frames[0][1].shape[0]}x"
        f"{frames[0][1].shape[1]}, launches {launches}, "
        f"frame_ms {frame_ms}, median frame_ms {statistics.median(frame_ms)}")
    for k, per in expect.items():
        if launches[k] != per * len(frames):
            raise AssertionError(f"{k}: {launches[k]} launches in "
                                 f"{len(frames)} frames, expected "
                                 f"{per} per frame")
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches, statistics.median(frame_ms)


def cross_check(overrides, lidf_cpu, refine_cpu, frame, dev):
    """One frame in f32 through the same weights on ``dev`` (kernels) and on
    the CPU (plain versions), with the same valid-point draw. Returns the
    frame's (valid pair slots, rays)."""
    from implicit_depth_torch.config import load_config
    from implicit_depth_torch.geometry.sampling import sample_valid_stratified
    from implicit_depth_torch.infer import DepthCompleter
    from implicit_depth_torch.models.lidf import prepare_inputs

    cfg32 = load_config(overrides={**overrides,
                                   "tpu": {**overrides.get("tpu", {}),
                                           "compute_dtype": "float32"}})
    for m in (lidf_cpu, refine_cpu):
        m.dtype = torch.float32
    runs = {}
    for device, lm, rm in ((dev, copy.deepcopy(lidf_cpu),
                            copy.deepcopy(refine_cpu)),
                           ("cpu", lidf_cpu, refine_cpu)):
        c = DepthCompleter(cfg32, lidf=lm, refine=rm, device=device)
        batch = c.device_batch(*([x] for x in frame))
        vidx, _, _ = sample_valid_stratified(
            (batch["depth_corrupt"] != 0).cpu(), lm.static.n_valid,
            torch.Generator().manual_seed(SEED))
        with torch.inference_mode():
            inputs = prepare_inputs(lm.static, batch, valid_idx=vidx)
            out = lm(inputs)
            pred = out["pred_pos"]
            for _ in range(cfg32.refine.forward_times):
                pred = rm(inputs, out, pred)
        runs[str(device)] = (out["max_slot"].cpu(), pred[..., 2].float().cpu())
    (slot_a, z_a), (slot_b, z_b) = runs[str(dev)], runs["cpu"]
    slot_same = (slot_a == slot_b).float().mean().item()
    diff = (z_a - z_b).abs()
    agree = (diff <= XCHECK_ATOL).float().mean().item()
    log(f"cross-check f32 {dev} vs cpu: stage-1 slots equal {slot_same:.6f}, "
        f"depth_pred within {XCHECK_ATOL} m: {agree:.6f}, "
        f"median |diff| {diff.median().item():.3g}, max |diff| "
        f"{diff.max().item():.3g}")
    if agree < 1 - XCHECK_FRAC or slot_same < 1 - XCHECK_FRAC:
        raise AssertionError("cross-check: the card and the CPU disagree")
    valid = inputs["pair_valid"]
    return int(valid.sum().item()), valid.shape[0] * valid.shape[1]


def train_batches(n, cfg, batch, dev, seed=SEED):
    """``n`` seeded synthetic training batches at the config's resolution,
    as device tensors."""
    from implicit_depth_torch.data.synthetic import synthetic_batch
    h, w = cfg.dataset.img_height, cfg.dataset.img_width
    return [{k: torch.from_numpy(v).to(dev)
             for k, v in synthetic_batch(seed + 1 + i, batch, h, w).items()}
            for i in range(n)]


def train_kernel_modules(decode_bwd="kernel_save"):
    """(module, attribute) of each kernel wrapper as a train step calls it:
    the forward K2 (``kernel_save``), K2 'all' (``kernel_save_all``) or K1
    (``kernel``, ``xla``), K3, K5."""
    from implicit_depth_torch.models import pointnet
    from implicit_depth_torch.ops import ray_decode as rd
    fwd = {"kernel_save": "ray_decode_save",
           "kernel_save_all": "ray_decode_save_all"}.get(decode_bwd,
                                                         "ray_decode")
    return {fwd: (rd, fwd), "ray_decode_bwd": (rd, "ray_decode_bwd"),
            "segment_max0": (pointnet, "segment_max0")}


def record_train_calls(step, state, batch, gen, decode_bwd="kernel_save"):
    """One (warm-up) train step; returns {name: (args, kwargs)} of the first
    call of the decode's forward (K2 or K1) and of K3, {(name, shapes):
    (args, kwargs)} of each K5 call under "segment_max0", and under
    "f32_operands" the decode's weight operands in f32 from the weights that
    step saw."""
    from implicit_depth_torch.models.lidf import decoder_weights
    from implicit_depth_torch.ops import ray_decode as rd
    m = state.model
    f32 = rd.prep_ray_decode_weights(
        {k: v.detach().clone() for k, v in
         decoder_weights(m.offset_dec, m.prob_dec).items()},
        m.dims["c_vox"], m.dims["c_roi"], m.dims["c_dir"], m.multires,
        torch.float32)
    losses = {}
    calls = record_calls(train_kernel_modules(decode_bwd),
                         lambda: losses.update(step(state, batch, gen, 0)))
    assert all(torch.isfinite(v) for v in losses.values()), losses
    recorded = {"f32_operands": f32, "segment_max0": {}}
    for (name, shape), (a, kw) in calls.items():
        if name == "segment_max0":  # the step's graph is gone: detach
            recorded[name][(name, shape)] = ((a[0].detach(), *a[1:]), kw)
        else:
            recorded.setdefault(name, (a, kw))
    return recorded


def segment_train_phase(calls, dev):
    """K5 at the shapes a train step gives it ({(name, shapes): (args,
    kwargs)}): the forward against its plain version in bf16 and f32 (as
    ``forward_rows``), and its gradient, taken through the wrapper's
    autograd Function after the kernel's forward, against autograd of
    ``segment_max0_plain`` on the same inputs and a seeded cotangent.
    Both share a segment's cotangent among its tied rows: exact. The
    plain autograd runs on the inputs in f32, since its bf16 run counts
    the ties in bf16, which cannot count past 256. Returns the forward
    row at the largest shape with the backward's rows under "bwd"."""
    from implicit_depth_torch.ops import segment

    with torch.inference_mode():
        row = forward_rows(calls, segment_as_f32, dev)["segment_max0"]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    row["bwd"] = {}
    for (_, shape), (a, _) in sorted(calls.items()):
        d0, ids, ns, v = a
        g0 = torch.randn((ns, d0.shape[1]), generator=gen, device=dev)
        for dt in (torch.bfloat16, torch.float32):
            d, g = d0.to(dt), g0.to(dt)
            x = d.clone().requires_grad_()
            out = segment.segment_max0(x, ids, ns, v)
            got, = torch.autograd.grad(out, x, g, retain_graph=True)
            x32 = d.float().requires_grad_()
            ref, = torch.autograd.grad(
                segment.segment_max0_plain(x32, ids, ns, v), x32, g.float())
            ref = ref.to(dt)
            xp = d.clone().requires_grad_()
            yp = segment.segment_max0_plain(xp, ids, ns, v)
            same_dt, = torch.autograd.grad(yp, xp, g, retain_graph=True)
            err = (got.float() - ref.float()).abs().max().item()
            err_dt = (got.float() - same_dt.float()).abs().max().item()
            tie = d == out.detach()[ids.long()]
            if v is not None:
                tie &= v[:, None]
            most = torch.zeros(out.shape, device=dev).index_add_(
                0, ids.long(), tie.float()).max().item()
            ms = time_ms(lambda: torch.autograd.grad(out, x, g,
                                                     retain_graph=True))
            plain_ms = time_ms(lambda: torch.autograd.grad(yp, xp, g,
                                                           retain_graph=True))
            b_ms, b_by, flops, byt = bound("segment_max0_bwd",
                                           (d, ids, ns, v, out, g), dt)
            dtn = str(dt).split(".")[-1]
            log(f"kernel segment_max0 backward {dtn} {list(d.shape)} -> "
                f"{ns} segments: max_abs_err {err:.3g} (tol 0; cotangents "
                f"std {g.float().std().item():.3g}; against the plain "
                f"autograd in {dtn} itself {err_dt:.3g}; most rows tied at "
                f"a segment's maximum in one channel {most:.0f}) ms {ms:.4f} "
                f"plain_ms {plain_ms:.4f} bound_ms {b_ms:.4f} ({b_by})")
            if err != 0.0 or not torch.isfinite(got).all():
                raise AssertionError(f"segment_max0 backward {dt} "
                                     f"{list(d.shape)}: {err} != 0")
            if dtn not in row["bwd"] or \
                    d.numel() >= np.prod(row["bwd"][dtn]["shape"]):
                row["bwd"][dtn] = {"shape": list(d.shape),
                                   "max_abs_err": err, "ms": ms,
                                   "plain_ms": plain_ms, "library_ms": None,
                                   "bound_ms": b_ms, "bound_by": b_by}
    return row


def bwd_checks(name, dt, got, ref, tol, floors):
    """K3's (d_vox_table, d_ray_feat, {operand: gradient}) ``got`` against
    the plain version's ``ref``, each gradient by the relative norm of the
    difference (``rel_norm`` with ``floors``) within ``tol``, logged; raises
    on a miss. Returns ([(what, got, ref)], (worst what, its relative
    error), its max |difference|)."""
    worst, err, failed = ("", 0.0), 0.0, []
    pairs = [("d_vox_table", got[0], ref[0]), ("d_ray_feat", got[1], ref[1])]
    pairs += [(k, got[2][k], ref[2][k]) for k in got[2]]
    for nm, g, r in pairs:
        e = rel_norm(g, r, floors.get(nm, 0.0))
        log(f"kernel {name} {str(dt).split('.')[-1]} {nm}: relative error "
            f"{e:.3g}, max |diff| {(g - r).abs().max().item():.3g}, max "
            f"|ref| {r.abs().max().item():.3g}")
        if not (torch.isfinite(g).all() and e <= tol):
            failed.append(f"{nm}: relative error {e} > {tol}")
        if e >= worst[1]:
            worst, err = (nm, e), (g - r).abs().max().item()
    if failed:
        raise AssertionError(f"{name} {dt}: {failed}")
    return pairs, worst, err


@torch.no_grad()
def train_kernel_phase(recorded):
    """K2 and K3 at the recorded training shapes, in bf16 (as recorded) and
    f32: kernel vs plain, times, bounds. Returns each kernel's bf16 row."""
    from implicit_depth_torch.ops import ray_decode as rd

    w32 = recorded["f32_operands"]
    (vt, cells, pos, rf, w_bf), kw2 = recorded["ray_decode_save"]
    a3, kw3 = recorded["ray_decode_bwd"]
    g_off, g_logit = a3[6], a3[7]
    rows = {}
    for dt in (torch.bfloat16, torch.float32):
        w = w_bf if dt == torch.bfloat16 else w32
        a2 = (vt.to(dt), cells, pos, rf.to(dt), w)
        # K2: outputs as K1's; saves relative to their largest value
        got, ref = rd.ray_decode_save(*a2, **kw2), \
            rd.ray_decode_plain(*a2, **kw2, saves=True)
        torch.cuda.synchronize()
        tol_out = TRAIN_TOL[("ray_decode_save_out", dt)]
        checks = [("offset", got[0], ref[0], tol_out),
                  ("logit", got[1], ref[1], tol_out)]
        for nm, g, r in zip(("e1", "z1p", "trig"), got[2], ref[2]):
            checks.append((nm, g, r, TRAIN_TOL[("ray_decode_save", dt)]
                           * r.float().abs().max().item()))
        err2 = row_checks("ray_decode_save", dt, checks)
        saved = got[2]
        # K3: every gradient against autograd of the plain decode started
        # from the same saves, by the relative norm of the difference
        a3 = (*a2, saved, g_off, g_logit)
        k3 = rd.ray_decode_bwd(*a3, **kw3)
        p3 = rd.ray_decode_bwd_plain(*a2[:4], w, g_off, g_logit, **kw3,
                                     dtype=dt, saved=saved)
        torch.cuda.synchronize()
        tol3 = TRAIN_TOL[("ray_decode_bwd", dt)]
        floors = {"off_b4": g_off.abs().sum().item(),
                  "prob_b4": g_logit.abs().sum().item()}
        pairs, worst, err3 = bwd_checks("ray_decode_bwd", dt, k3, p3, tol3,
                                        floors)
        # against the exact gradient of the plain decode (not from the
        # saves), for the record: the bf16 saves move it by a few percent
        exact = rd.ray_decode_bwd_plain(*a2[:4], w, g_off, g_logit, **kw3,
                                        dtype=dt)
        drift = max(rel_norm(g, r, floors.get(nm, 0.0)) for (nm, g, _), r in
                    zip(pairs, [exact[0], exact[1],
                                *(exact[2][k] for k in k3[2])]))
        log(f"kernel ray_decode_bwd {str(dt).split('.')[-1]}: worst relative error "
            f"{worst[1]:.3g} ({worst[0]}, tol {tol3}: the plain gradients' "
            f"own spread is 1); max |diff| there {err3:.3g}; from the exact "
            f"gradient of the unsaved decode at most {drift:.3g}")
        for name, args, kw, err, extra in (
                ("ray_decode_save", a2, kw2, err2, {}),
                ("ray_decode_bwd", a3, kw3, err3,
                 {"max_rel_err": worst[1], "worst": worst[0],
                  "tolerance_rel": tol3})):
            if name == "ray_decode_save":
                kern, plain = (lambda: rd.ray_decode_save(*a2, **kw2),
                               lambda: rd.ray_decode_plain(*a2, **kw2,
                                                           saves=True))
            else:
                kern = lambda: rd.ray_decode_bwd(*a3, **kw3)  # noqa: E731
                plain = lambda: rd.ray_decode_bwd_plain(  # noqa: E731
                    *a2[:4], w, g_off, g_logit, **kw3, dtype=dt, saved=saved)
            ms = time_ms(kern, warmup=1, reps=5)
            plain_ms = time_ms(plain, warmup=1, reps=3)
            b_ms, b_by, flops, byt = bound(name, args, dt)
            if name == "ray_decode_bwd":
                extra = {**extra, "passes": k3_passes(a3, kw3)}
            row = {"name": name, "dtype": str(dt).split(".")[-1],
                   "shape": [list(cells.shape)], "max_abs_err": err,
                   "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                   "bound_ms": b_ms, "bound_by": b_by, "flops": flops,
                   "bytes": byt, **extra}
            log(f"kernel {name} {row['dtype']} {row['shape']}: ms {ms:.4f} "
                f"plain_ms {plain_ms:.4f} bound_ms {b_ms:.4f} ({b_by})")
            if dt == torch.bfloat16:
                rows[name] = row
        del a3, k3, p3, exact, got, ref
        torch.cuda.empty_cache()
    return rows


def k3_passes(a, kw):
    """K3's passes on the operands ``a`` (as ``ray_decode_bwd`` takes them):
    the device ms of Pass A and of Pass B over all chunks and of the final
    reduction (median of 3 calls after one, from CUDA events the C function
    records between its launches), the plan's scratch bytes, and the peak
    device memory one call adds to what is allocated before it."""
    from implicit_depth_torch.ops import ray_decode as rd
    rd.ray_decode_bwd_pass_ms(*a, **kw)
    runs = [rd.ray_decode_bwd_pass_ms(*a, **kw) for _ in range(3)]
    out = {k: statistics.median(r[k] for r in runs)
           for k in ("pass_a_ms", "pass_b_ms", "reduce_ms")}
    out.update(chunks=runs[0]["chunks"], scratch_bytes=runs[0]["scratch_bytes"])
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = rd.ray_decode_bwd(*a, **kw)
    torch.cuda.synchronize()
    out["peak_bytes"] = torch.cuda.max_memory_allocated() - base
    del got
    log(f"kernel ray_decode_bwd passes: {out}")
    return out


def row_checks(name, dt, checks):
    """Each (what, got, ref, tol): max |got - ref| <= tol, finite, and tol
    BITE times below the spread of ref; returns the largest error."""
    worst, failed = 0.0, []
    for what, g, r, tol in checks:
        err = (g.float() - r.float()).abs().max().item()
        spread = r.float().std().item()
        log(f"kernel {name} {str(dt).split('.')[-1]} {what}: max_abs_err "
            f"{err:.3g} (tol {tol:.3g}; std {spread:.3g})")
        if not (err <= tol and torch.isfinite(g).all()):
            failed.append(f"{what}: {err} > {tol}")
        if BITE * tol > spread:
            failed.append(f"{what}: tolerance {tol} is not {BITE}x below the "
                          f"spread {spread}")
        worst = max(worst, err)
    if failed:
        raise AssertionError(f"{name} {dt}: {failed}")
    return worst


def train_path(cfg, model, dev, profile=False, expect=EXPECT_PER_STEP):
    """Warm-up step (recording the kernels' inputs), then TRAIN_STEPS timed
    steps with the launch counters of ``expect`` from 0; returns (recorded,
    launches, step_ms)."""
    from implicit_depth_torch.train.state import TrainState
    from implicit_depth_torch.train.steps import make_lidf_train_step

    decode_bwd = cfg.tpu.decode_bwd
    state = TrainState.create(model, cfg.training, steps_per_epoch=1000)
    step = make_lidf_train_step(cfg, model, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    batches = train_batches(TRAIN_STEPS + 1, cfg, TRAIN_BATCH, dev)
    recorded = record_train_calls(step, state, batches[0], gen, decode_bwd)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    counts = {k: f for k, f in counters().items() if k in expect}
    torch.cuda.reset_peak_memory_stats()
    for f in counts.values():
        f.launches = 0
    step_ms, losses = [], []
    for i, b in enumerate(batches[1:]):
        t0 = time.perf_counter()
        out = step(state, b, gen, i)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append({k: v.item() for k, v in out.items()})
    launches = {k: f.launches for k, f in counts.items()}
    log(f"training (decode_bwd {decode_bwd}): {TRAIN_STEPS} steps of batch "
        f"{TRAIN_BATCH} at {cfg.dataset.img_height}x{cfg.dataset.img_width}, "
        f"launches "
        f"{launches}, step_ms {step_ms}, median step_ms "
        f"{statistics.median(step_ms)}")
    log(f"training losses {losses}")
    log(f"training peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for k, per in expect.items():
        if launches[k] != per * TRAIN_STEPS:
            raise AssertionError(f"{k}: {launches[k]} launches in "
                                 f"{TRAIN_STEPS} steps, expected {per} each")
    if not all(np.isfinite(v) for ls in losses for v in ls.values()):
        raise AssertionError("training: a loss is not finite")
    still = [n for n, p in model.named_parameters()
             if torch.equal(p.detach(), before[n])]
    if still:
        raise AssertionError(f"training: parameters did not move: {still}")
    if profile:
        profile_device_ms(lambda: step(state, batches[1], gen, 0),
                          f"training (decode_bwd {decode_bwd}): device time "
                          "of one step")
    return recorded, launches, step_ms


def profile_device_ms(fn, label):
    """One call of ``fn`` under torch.profiler: logs the table and ``label``
    with the device time, the table's "Self CUDA time total" (the device
    operations' own entries, user annotations left out); returns it in
    ms."""
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    with prof_ctx(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    log(events.table(sort_by="cuda_time_total", row_limit=30))
    device_us = sum(ev.self_device_time_total for ev in events
                    if str(ev.device_type).endswith("CUDA")
                    and not getattr(ev, "is_user_annotation", False))
    log(f"{label} {device_us / 1e3:.3f} ms (the sum of every device "
        "operation's time)")
    return device_us / 1e3


def train_cross_check(dev):
    """For each seed of XCHECK_SEEDS, one f32 train step of the same weights
    on the card (kernels) and on the CPU (plain versions), same valid-point
    and ray-window draws. For the first seed the card also runs the step
    with cuDNN held to deterministic algorithms and with cuDNN off
    (PyTorch's own convolutions): how far those move the ResNet's gradients
    from the card's default run shows how much of its distance to the CPU
    the choice of convolution algorithm makes. Every seed is logged before
    a failure is raised."""
    failed = []
    for seed in XCHECK_SEEDS:
        failed += cross_check_seed(dev, seed, witness=seed == XCHECK_SEEDS[0])
    if failed:
        raise AssertionError(f"train cross-check: the card and the CPU "
                             f"disagree: {failed}")


@contextlib.contextmanager
def cudnn_flags(**flags):
    """``torch.backends.cudnn``'s attributes set to ``flags`` for the
    block (TF32 stays as ``main`` set it: off)."""
    old = {k: getattr(torch.backends.cudnn, k) for k in flags}
    for k, v in flags.items():
        setattr(torch.backends.cudnn, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(torch.backends.cudnn, k, v)


def cross_check_seed(dev, seed, witness):
    """One seed of ``train_cross_check``; returns what failed."""
    from implicit_depth_torch.builder import (
        build_lidf,
        build_static,
        randomize_weights_,
    )
    from implicit_depth_torch.config import load_config
    from implicit_depth_torch.geometry.sampling import (
        sample_masked_window,
        sample_valid_stratified,
    )
    from implicit_depth_torch.models.lidf import decoder_weights
    from implicit_depth_torch.ops import ray_decode as rd
    from implicit_depth_torch.train.state import TrainState
    from implicit_depth_torch.train.steps import make_lidf_train_step

    cfg = load_config(overrides=XCHECK_TRAIN)
    static = build_static(cfg)
    gen = torch.Generator().manual_seed(seed)
    model = randomize_weights_(build_lidf(cfg, static, gen), gen)
    batch = train_batches(1, cfg, 1, "cpu", seed)[0]
    vidx, _, _ = sample_valid_stratified(batch["valid_mask"] > 0.5,
                                         static.n_valid, gen)
    _, _, _, mstart = sample_masked_window(
        (batch["corrupt_mask"] > 0.5).reshape(1, -1), static.n_rays, gen)
    # the decoders' last biases: their gradients are sums of the decode's
    # cotangents that cancel (see rel_norm), measured against the sum of
    # the cotangents' magnitudes, taken from the card's K3 call
    floors = {}
    bwd = rd.ray_decode_bwd

    def recorder(*a, **kw):
        floors["off_b4"] = a[6].abs().sum().item()
        floors["prob_b4"] = a[7].abs().sum().item()
        return bwd(*a, **kw)

    recorder.launches = 0
    variants = [("card", dev, contextlib.nullcontext()),
                ("cpu", torch.device("cpu"), contextlib.nullcontext())]
    if witness:
        variants += [("card, cuDNN deterministic", dev,
                      cudnn_flags(deterministic=True, benchmark=False)),
                     ("card, cuDNN off", dev, cudnn_flags(enabled=False))]
    runs, last_bias = {}, {}
    for label, device, ctx in variants:
        m = copy.deepcopy(model).to(device)
        state = TrainState.create(m, cfg.training, steps_per_epoch=1000)
        rd.ray_decode_bwd = recorder if label == "card" else bwd
        try:
            with ctx:
                losses = make_lidf_train_step(cfg, m, device)(
                    state, {k: v.to(device) for k, v in batch.items()}, None,
                    0, valid_idx=vidx, miss_start=mstart)
        finally:
            rd.ray_decode_bwd = bwd
        names = {id(p): n for n, p in m.named_parameters()}
        last_bias = {names[id(p)]: k for k, p in decoder_weights(
            m.offset_dec, m.prob_dec).items() if k in floors}
        runs[label] = ({k: v.item() for k, v in losses.items()},
                       {n: p.grad.cpu() for n, p in m.named_parameters()})

    def compare(a, b):
        (la, ga), (lb, gb) = runs[a], runs[b]
        loss_err = max(abs(la[k] - lb[k]) / max(abs(lb[k]), 1e-6) for k in lb)
        errs = {n: rel_norm(ga[n], gb[n], floors[last_bias[n]]
                            if n in last_bias else 0.0) for n in gb}
        groups = {}
        for group in ("resnet", "decoders and pnet"):
            errs_g = {n: e for n, e in errs.items()
                      if n.startswith("resnet.") == (group == "resnet")}
            worst = max(errs_g, key=errs_g.get)
            groups[group] = (errs_g[worst], worst,
                             statistics.median(errs_g.values()))
        log(f"train cross-check f32 seed {seed}, {a} vs {b} "
            f"({cfg.dataset.img_height}x{cfg.dataset.img_width}, "
            f"{static.n_rays} rays): largest relative loss difference "
            f"{loss_err:.3g}; gradients, largest relative error (median): "
            + "; ".join(f"{g} {w:.3g} ({n}) ({med:.3g})"
                        for g, (w, n, med) in groups.items()))
        return loss_err, groups

    log(f"train cross-check f32 seed {seed}: losses card {runs['card'][0]} "
        f"cpu {runs['cpu'][0]}")
    loss_err, groups = compare("card", "cpu")
    failed = []
    if loss_err > XCHECK_LOSS_RTOL:
        failed.append(f"seed {seed} losses: {loss_err} > {XCHECK_LOSS_RTOL}")
    for group, tol in (("resnet", XCHECK_RESNET_RTOL),
                       ("decoders and pnet", XCHECK_GRAD_RTOL)):
        if groups[group][0] > tol:
            failed.append(f"seed {seed} {group}: {groups[group][0]} ("
                          f"{groups[group][1]}) > {tol}")
    for label, _, _ in variants[2:]:
        compare(label, "cpu")
        compare(label, "card")
    return failed


def mode_overrides(overrides, mode, **extra):
    """``overrides`` in the decode mode ``mode`` (of MODES)."""
    out = {**overrides, **extra}
    out["tpu"] = {**overrides.get("tpu", {}), **MODES[mode]}
    return out


def build_models(cfg, train=False, seed=SEED):
    """The stage-1 and stage-2 models of ``cfg`` (every pixel a ray, or
    with ``train`` the training rays) with the seeded weights at unit
    activation scale that every serving phase uses."""
    from implicit_depth_torch.builder import (
        build_lidf,
        build_refine,
        build_static,
        randomize_weights_,
    )
    static = build_static(cfg) if train else build_static(
        cfg, n_rays=cfg.dataset.img_height * cfg.dataset.img_width)
    gen = torch.Generator().manual_seed(seed)
    lidf = randomize_weights_(build_lidf(cfg, static, gen), gen)
    refine = randomize_weights_(build_refine(cfg, static, gen), gen)
    return lidf, refine


def pair_kernel_rows(recorded, lidf, dev):
    """K6 on the calls recorded from a served frame (``forward_rows``, with
    the weights re-prepared in f32 for the f32 run)."""
    from implicit_depth_torch.models.lidf import decoder_weights
    from implicit_depth_torch.ops import pair_decode as pd

    f32w = pd.prep_pair_decode_weights(
        decoder_weights(lidf.offset_dec, lidf.prob_dec), lidf.dims["c_vox"],
        lidf.dims["c_roi"], lidf.dims["c_dir"], lidf.multires, torch.float32)

    def as_f32(name, a):
        vt, cells, pos, rf, _, rays = a
        return vt.float(), cells, pos, rf.float(), f32w, rays

    with torch.inference_mode():
        row = forward_rows(recorded, as_f32, dev)["pair_decode"]
    row.setdefault("rows_decoded", row["shape"][1][0])  # cells: every row
    return row


def mode_pairs(dc, frames, budget):
    """(valid pair slots, pairs the global budget dropped) of each frame, from
    the geometry its served run computed (same seed, same valid draw)."""
    from implicit_depth_torch.models.lidf import prepare_inputs
    out = []
    for rgb, depth, intr in frames:
        batch = dc.device_batch([rgb], [depth], [intr])
        gen = torch.Generator(device=dc.device).manual_seed(0)
        with torch.inference_mode():
            valid = prepare_inputs(dc.static, batch, mask_type="all",
                                   generator=gen)["pair_valid"]
        b, r, _ = valid.shape
        n = int(valid.sum().item())
        out.append((n, max(n - b * r * budget, 0) if budget else 0))
    return out


def pair_modes_phase(dev, overrides, frame_hw, profile=False):
    """Phase 9: the global and dense decode modes (see the module doc).
    Returns K6's row (its largest bf16 shape, the dense frame's) with each
    mode's under "modes", and the launches of both modes' runs."""
    from implicit_depth_torch.config import load_config
    from implicit_depth_torch.infer import DepthCompleter

    frames = make_frames(MODE_FRAMES + 1, frame_hw)
    rows = {}
    for mode in MODES:
        cfg = load_config(overrides=mode_overrides(overrides, mode))
        lidf, refine = build_models(cfg)
        assert lidf.decode_mode == mode, lidf.decode_mode
        dc = DepthCompleter(cfg, lidf=lidf, refine=refine, device=dev)
        recorded = record_calls({"pair_decode": kernel_modules()["pair_decode"]},
                                lambda: dc.complete(*frames[0]))
        mode_row = pair_kernel_rows(recorded, lidf, dev)
        launches, frame_ms = main_path(
            dc, frames[1:], cfg, EXPECT_PER_MODE_FRAME, f"{mode} mode")
        if profile:
            mode_row["frame_device_ms"] = profile_device_ms(
                lambda: dc.complete(*frames[1]),
                f"{mode} mode: device time of one frame")
        budget = cfg.tpu.pairs_budget_per_ray if mode == "global" else 0
        pairs = mode_pairs(dc, frames[1:], budget)
        log(f"{mode} mode: valid pairs per frame {[v for v, _ in pairs]}, "
            f"dropped by the budget {[d for _, d in pairs]} (budget "
            f"{budget or 'none'} per ray, {lidf.static.k_pairs} slots)")
        rows[mode] = add_launches(
            {**mode_row, "frame_ms": frame_ms,
             "valid_pairs": [v for v, _ in pairs],
             "dropped_pairs": [d for _, d in pairs]},
            launches["pair_decode"], MODE_FRAMES, "frame")
        del dc, lidf, refine
        torch.cuda.empty_cache()
        # the f32 cross-check, at MODE_XCHECK_DATASET and MODE_XCHECK_TPU
        xo = mode_overrides(overrides, mode, dataset=MODE_XCHECK_DATASET)
        xo["tpu"].update(MODE_XCHECK_TPU[mode])
        xcfg = load_config(overrides=xo)
        n_pairs, n_rays = cross_check(xo, *build_models(xcfg), frames[1], dev)
        if mode == "global":
            budget = xcfg.tpu.pairs_budget_per_ray
            dropped = max(n_pairs - n_rays * budget, 0)
            log(f"global cross-check: {n_pairs} valid pairs, budget {budget} "
                f"per ray over {n_rays} rays dropped {dropped}")
            if dropped == 0:
                raise AssertionError("global cross-check: the budget dropped "
                                     "no pair")
            rows[mode]["xcheck_dropped_pairs"] = dropped
        torch.cuda.empty_cache()
    # the JSON row at the largest shape (the dense frame's), as forward_rows
    row = dict(max(rows.values(), key=lambda r: np.prod(r["shape"][1])))
    row["modes"] = {m: {k: r[k] for k in (
        "shape", "max_abs_err", "tolerance", "ms", "plain_ms", "bound_ms",
        "bound_by", "rows_decoded", "ms_all_rows", "bound_ms_all_rows",
        "frame_ms", "frame_device_ms", "valid_pairs", "dropped_pairs",
        "xcheck_dropped_pairs", "launches", "launches_per_frame") if k in r}
        for m, r in rows.items()}
    # registers and spills of the K6 entries, from this run's build
    row["ptxas"] = ptxas_of("pair_decode.cu", "pair_decode")
    log(f"pair_decode ptxas: {row['ptxas']}")
    row["launches"] = sum(r["launches"] for r in rows.values())
    row["launches_per_frame"] = {m: r["launches_per_frame"]
                                 for m, r in rows.items()}
    return row


@torch.no_grad()
def recompute_kernel_rows(recorded):
    """Phase 10's kernel check: K3's recompute instance (``saved=None``) on
    the recorded training inputs against ``ray_decode_bwd_plain(saved=None)``
    in bf16 (as recorded) and f32, by the relative norm of each gradient's
    difference; times, bound. Returns its bf16 row."""
    from implicit_depth_torch.ops import ray_decode as rd

    w32 = recorded["f32_operands"]
    (vt, cells, pos, rf, w_bf, saved, g_off, g_logit), kw = \
        recorded["ray_decode_bwd"]
    assert saved is None
    floors = {"off_b4": g_off.abs().sum().item(),
              "prob_b4": g_logit.abs().sum().item()}
    out = None
    for dt in (torch.bfloat16, torch.float32):
        w = w_bf if dt == torch.bfloat16 else w32
        a = (vt.to(dt), cells, pos, rf.to(dt), w, None, g_off, g_logit)
        got = rd.ray_decode_bwd(*a, **kw)
        ref = rd.ray_decode_bwd_plain(*a[:5], g_off, g_logit, **kw, dtype=dt,
                                      saved=None)
        torch.cuda.synchronize()
        tol = TRAIN_TOL[("ray_decode_bwd_recompute", dt)]
        dtn = str(dt).split(".")[-1]
        _, worst, err = bwd_checks("ray_decode_bwd_recompute", dt, got, ref,
                                   tol, floors)
        log(f"kernel ray_decode_bwd_recompute {dtn} {list(cells.shape)}: "
            f"worst relative error {worst[1]:.3g} ({worst[0]}, tol {tol}), "
            f"max |diff| there {err:.3g}")
        del got, ref
        ms = time_ms(lambda: rd.ray_decode_bwd(*a, **kw), warmup=1, reps=5)
        plain_ms = time_ms(lambda: rd.ray_decode_bwd_plain(
            *a[:5], g_off, g_logit, **kw, dtype=dt, saved=None),
            warmup=1, reps=3)
        b_ms, b_by, flops, byt = bound("ray_decode_bwd_recompute", a, dt)
        log(f"kernel ray_decode_bwd_recompute {dtn}: ms {ms:.4f} plain_ms "
            f"{plain_ms:.4f} bound_ms {b_ms:.4f} ({b_by})")
        passes = k3_passes(a, kw)
        if dt == torch.bfloat16:
            out = {"name": "ray_decode_bwd_recompute", "dtype": dtn,
                   "shape": [list(cells.shape)], "max_abs_err": err,
                   "max_rel_err": worst[1], "worst": worst[0],
                   "tolerance_rel": tol, "ms": ms, "plain_ms": plain_ms,
                   "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
                   "flops": flops, "bytes": byt, "passes": passes}
        torch.cuda.empty_cache()
    return out


def train_forward_row(recorded, dev):
    """Phase 10's forward check: K1 on the recorded training inputs against
    ``ray_decode_plain`` (``forward_rows``), at K2's output tolerances: the
    same decode, whose outputs spread less under the training weights than
    the served ones, so that K1's serving tolerance would not bite."""
    w32 = recorded["f32_operands"]
    a, kw = recorded["ray_decode"]
    shape = tuple(tuple(t.shape) for t in a if torch.is_tensor(t))

    def as_f32(name, a):
        vt, cells, pos, rf, _ = a
        return vt.float(), cells, pos, rf.float(), w32

    tols = {("ray_decode", dt): TRAIN_TOL[("ray_decode_save_out", dt)]
            for dt in (torch.bfloat16, torch.float32)}
    with torch.inference_mode():
        return forward_rows({("ray_decode", shape): (a, kw)}, as_f32, dev,
                            tols)["ray_decode"]


def train_kernel_variant_phase(dev, train_overrides, profile=False):
    """Phase 10: training with ``decode_bwd: kernel``. Returns K1's row at
    the training shapes and K3's recompute row, each with its launches."""
    cfg, model = train_mode_model(dev, train_overrides, "kernel")
    recorded, launches, step_ms = train_path(cfg, model, dev, profile,
                                             expect=EXPECT_PER_STEP_KERNEL)
    del model
    torch.cuda.empty_cache()
    k1 = add_launches(train_forward_row(recorded, dev),
                      launches["ray_decode"], TRAIN_STEPS, "step")
    k3 = add_launches(recompute_kernel_rows(recorded),
                      launches["ray_decode_bwd"], TRAIN_STEPS, "step")
    k3["step_ms"] = statistics.median(step_ms)
    return k1, k3


def train_mode_model(dev, train_overrides, decode_bwd):
    """The config and seeded training model of ``train_overrides`` with
    ``tpu.decode_bwd`` set (the weights of phase 6's model)."""
    from implicit_depth_torch.builder import (
        build_lidf,
        build_static,
        randomize_weights_,
    )
    from implicit_depth_torch.config import load_config

    cfg = load_config(overrides={**train_overrides, "tpu": {
        **train_overrides.get("tpu", {}), "decode_bwd": decode_bwd}})
    gen = torch.Generator().manual_seed(SEED + 1)
    return cfg, randomize_weights_(build_lidf(cfg, build_static(cfg), gen),
                                   gen).to(dev)


@torch.no_grad()
def save_all_kernel_rows(recorded):
    """Phase 11's kernel checks on the recorded training inputs, in bf16 (as
    recorded) and f32: K2 'all' against ``ray_decode_plain(saves='all')``,
    K3 from its full saves against ``ray_decode_bwd_plain`` from the same
    saves. Returns both kernels' bf16 rows."""
    from implicit_depth_torch.ops import ray_decode as rd

    w32 = recorded["f32_operands"]
    (vt, cells, pos, rf, w_bf), kw2 = recorded["ray_decode_save_all"]
    a3, kw3 = recorded["ray_decode_bwd"]
    g_off, g_logit = a3[6], a3[7]
    names = rd.save_names(kw2["n_iter"], "all")
    floors = {"off_b4": g_off.abs().sum().item(),
              "prob_b4": g_logit.abs().sum().item()}
    rows = {}
    for dt in (torch.bfloat16, torch.float32):
        dtn = str(dt).split(".")[-1]
        w = w_bf if dt == torch.bfloat16 else w32
        a2 = (vt.to(dt), cells, pos, rf.to(dt), w)
        got = rd.ray_decode_save_all(*a2, **kw2)
        ref = rd.ray_decode_plain(*a2, **kw2, saves="all")
        torch.cuda.synchronize()
        # outputs, and the f32 offsets and logit before the squash (the
        # soft clamp is the identity on (0, 1)), at K2's output tolerance;
        # the other saves within an ulp of their largest value; the offset
        # entering the first iteration is init_offset, exactly
        tol_out = TRAIN_TOL[("ray_decode_save_out", dt)]
        checks = [("offset", got[0], ref[0], tol_out),
                  ("logit", got[1], ref[1], tol_out)]
        for nm, g, r in zip(names, got[2], ref[2]):
            if nm == "off0":
                if not torch.equal(g, r):
                    raise AssertionError(f"ray_decode_save_all {dt}: off0 "
                                         "is not init_offset")
                continue
            f32 = nm.startswith("off") or nm == "logit"
            checks.append((nm, g, r, tol_out if f32 else
                           TRAIN_TOL[("ray_decode_save", dt)]
                           * r.float().abs().max().item()))
        err2 = row_checks("ray_decode_save_all", dt, checks)
        saved = got[2]
        a3 = (*a2, saved, g_off, g_logit)
        k3 = rd.ray_decode_bwd(*a3, **kw3)
        p3 = rd.ray_decode_bwd_plain(*a2[:4], w, g_off, g_logit, **kw3,
                                     dtype=dt, saved=saved)
        torch.cuda.synchronize()
        tol3 = TRAIN_TOL[("ray_decode_bwd_all", dt)]
        _, worst, err3 = bwd_checks("ray_decode_bwd_all", dt, k3, p3, tol3,
                                    floors)
        log(f"kernel ray_decode_bwd_all {dtn}: worst relative error "
            f"{worst[1]:.3g} ({worst[0]}, tol {tol3}), max |diff| there "
            f"{err3:.3g}")
        del k3, p3, ref
        torch.cuda.empty_cache()
        for name, args, kern, plain, err, extra in (
                ("ray_decode_save_all", a2,
                 lambda: rd.ray_decode_save_all(*a2, **kw2),
                 lambda: rd.ray_decode_plain(*a2, **kw2, saves="all"),
                 err2, {"save_bytes": sum(t.numel() * t.element_size()
                                          for t in saved)}),
                ("ray_decode_bwd_all", a3,
                 lambda: rd.ray_decode_bwd(*a3, **kw3),
                 lambda: rd.ray_decode_bwd_plain(
                     *a2[:4], w, g_off, g_logit, **kw3, dtype=dt,
                     saved=saved),
                 err3, {"max_rel_err": worst[1], "worst": worst[0],
                        "tolerance_rel": tol3})):
            ms = time_ms(kern, warmup=1, reps=5)
            plain_ms = time_ms(plain, warmup=1, reps=3)
            b_ms, b_by, flops, byt = bound(name, args, dt, kw2["n_iter"])
            if name == "ray_decode_bwd_all":
                extra = {**extra, "passes": k3_passes(a3, kw3)}
            log(f"kernel {name} {dtn} {list(cells.shape)}: ms {ms:.4f} "
                f"plain_ms {plain_ms:.4f} bound_ms {b_ms:.4f} ({b_by})")
            if dt == torch.bfloat16:
                rows[name] = {"name": name, "dtype": dtn,
                              "shape": [list(cells.shape)],
                              "max_abs_err": err, "ms": ms,
                              "plain_ms": plain_ms, "library_ms": None,
                              "bound_ms": b_ms, "bound_by": b_by,
                              "flops": flops, "bytes": byt, **extra}
        del a3, got, saved
        torch.cuda.empty_cache()
    return rows


def train_save_all_phase(dev, train_overrides, profile=False):
    """Phase 11: training with ``decode_bwd: kernel_save_all``. Returns the
    rows of K2 'all' and K3 from full saves, each with its launches."""
    cfg, model = train_mode_model(dev, train_overrides, "kernel_save_all")
    recorded, launches, step_ms = train_path(cfg, model, dev, profile,
                                             expect=EXPECT_PER_STEP_SAVE_ALL)
    del model
    torch.cuda.empty_cache()
    rows = save_all_kernel_rows(recorded)
    add_launches(rows["ray_decode_save_all"],
                 launches["ray_decode_save_all"], TRAIN_STEPS, "step")
    add_launches(rows["ray_decode_bwd_all"], launches["ray_decode_bwd"],
                 TRAIN_STEPS, "step")
    rows["ray_decode_bwd_all"]["step_ms"] = statistics.median(step_ms)
    return rows


def train_xla_phase(dev, train_overrides, profile=False):
    """Phase 12: training with ``decode_bwd: xla`` (K1, then autograd of the
    plain decode). Returns its launches per step and median step_ms."""
    cfg, model = train_mode_model(dev, train_overrides, "xla")
    _, launches, step_ms = train_path(cfg, model, dev, profile,
                                      expect=EXPECT_PER_STEP_XLA)
    del model
    torch.cuda.empty_cache()
    return {"launches_per_step": {k: n // TRAIN_STEPS
                                  for k, n in launches.items()},
            "step_ms": statistics.median(step_ms)}


# -- stage 2: training, its eval step, checkpoints (phases 13-17) ------------

def refine_kernel_modules():
    """(module, attribute) of each kernel entry as a refine train step calls
    it: the training IEF decode (K4's forward) and K5."""
    from implicit_depth_torch.models import pointnet, refine
    return {"ief_decode_train": (refine, "ief_decode_train"),
            "segment_max0": (pointnet, "segment_max0")}


def snapshot(a):
    """A recorded call's arguments, detached and copied: the training
    decode's f32 operands alias live parameters that the update changes."""
    def one(x):
        if torch.is_tensor(x):
            return x.detach().clone()
        if isinstance(x, dict):
            return {k: one(v) for k, v in x.items()}
        return x
    return tuple(one(x) for x in a)


def refine_train_path(cfg, lidf, refine, dev, steps, profile=False,
                      label="stage 2"):
    """A warm-up refine step (recording the inputs of K4's training entry
    and of the refine network's K5 calls, those with a gradient), then
    ``steps`` timed steps with the launch counters of
    EXPECT_PER_REFINE_STEP from 0: finite losses, every refine parameter
    moved, the frozen stage 1's parameters and buffers bit for bit.
    Returns a dict of the state, the step, the batches, the recorded calls,
    the launches, step_ms and (``profile``) the device time of a step."""
    from implicit_depth_torch.train.state import TrainState
    from implicit_depth_torch.train.steps import make_refine_train_step

    state = TrainState.create(refine, cfg.training, steps_per_epoch=1000)
    step = make_refine_train_step(cfg, lidf, refine, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    batches = train_batches(steps + 1, cfg, TRAIN_BATCH, dev)
    lidf_before = {k: v.clone() for k, v in lidf.state_dict().items()}
    warm = {}
    recorded = record_calls(refine_kernel_modules(),
                            lambda: warm.update(step(state, batches[0], gen,
                                                     0)),
                            when=lambda a: a[0].requires_grad, keep=snapshot)
    assert all(torch.isfinite(v) for v in warm.values()), warm
    before = {n: p.detach().clone() for n, p in refine.named_parameters()}
    counts = {k: f for k, f in counters().items()
              if k in EXPECT_PER_REFINE_STEP}
    torch.cuda.reset_peak_memory_stats()
    for f in counts.values():
        f.launches = 0
    step_ms, losses = [], []
    for i, b in enumerate(batches[1:]):
        t0 = time.perf_counter()
        out = step(state, b, gen, i)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append({k: v.item() for k, v in out.items()})
    launches = {k: f.launches for k, f in counts.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"{label}: {steps} steps of batch {TRAIN_BATCH} at "
        f"{cfg.dataset.img_height}x{cfg.dataset.img_width}, launches "
        f"{launches}, step_ms {step_ms}, median step_ms "
        f"{statistics.median(step_ms)}")
    log(f"{label} losses {losses}")
    log(f"{label} peak device memory {peak:.2f} GiB")
    for k, per in EXPECT_PER_REFINE_STEP.items():
        if launches[k] != per * steps:
            raise AssertionError(f"{label}: {k}: {launches[k]} launches in "
                                 f"{steps} steps, expected {per} each")
    if not all(np.isfinite(v) for ls in losses for v in ls.values()):
        raise AssertionError(f"{label}: a loss is not finite")
    still = [n for n, p in refine.named_parameters()
             if torch.equal(p.detach(), before[n])]
    if still:
        raise AssertionError(f"{label}: refine parameters did not move: "
                             f"{still}")
    changed = [k for k, v in lidf.state_dict().items()
               if not torch.equal(v, lidf_before[k])]
    if changed or any(p.requires_grad for p in lidf.parameters()):
        raise AssertionError(f"{label}: the frozen stage 1 changed: {changed}")
    log(f"{label}: every refine parameter moved; the stage-1 parameters and "
        f"buffers ({len(lidf_before)} tensors) are bit for bit as before")
    device = None
    if profile:
        device = profile_device_ms(lambda: step(state, batches[1], gen, 0),
                                   f"{label}: device time of one step")
    return {"state": state, "step": step, "batches": batches,
            "recorded": recorded, "launches": launches,
            "step_ms": statistics.median(step_ms), "peak_gib": peak,
            "device_ms": device}


def refine_k4_row(recorded, dev):
    """Phase 13's K4 checks on the recorded inputs of K4's training entry
    (one refine iteration's rows), in bf16 (as recorded) and f32: the
    kernel against ``ief_decode_plain`` (``forward_rows``, phase 3's
    tolerances), and the training decode's gradients (``IefDecodeTrain``:
    K4 forward, autograd of the plain decode recomputed) against autograd
    of ``ief_decode_plain`` on the same inputs, with the backward's time.
    Returns the bf16 row."""
    from implicit_depth_torch.ops import ray_decode as rd

    (_, shape), (a, kw) = next((k, v) for k, v in recorded.items()
                               if k[0] == "ief_decode_train")
    end, rc, pos, w32, dtype = a
    call = {("ief_decode", shape[:3]):
            ((end, rc, pos, rd.cast_ief_operands(w32, dtype)), kw)}

    def as_f32(name, args):
        e, r, p, _ = args
        return (e.float(), r.float(), p.float(),
                rd.cast_ief_operands(w32, torch.float32))

    with torch.inference_mode():
        row = forward_rows(call, as_f32, dev)["ief_decode"]
    g = torch.randn(end.shape[0], device=dev,
                    generator=torch.Generator(device=dev).manual_seed(SEED))
    row["grad"] = {}
    for dt in (torch.bfloat16, torch.float32):
        dtn = str(dt).split(".")[-1]
        wl = {k: w32[k].clone().requires_grad_() for k in rd._K4_WEIGHTS}
        w = dict(wl, dims=w32["dims"])
        e = end.to(dt).clone().requires_grad_()
        p = pos.to(dt).clone().requires_grad_()
        r = rc.to(dt)
        leaves = [e, p, *wl.values()]
        names = ["d_end", "d_pos", *wl]
        out = rd.ief_decode_train(e, r, p, w, dt, **kw)
        got = torch.autograd.grad(out, leaves, g, retain_graph=True)
        ref_out = rd.ief_decode_plain(e, r, p, rd._ief_train_operands(w, dt),
                                      dtype=dt, **kw)
        ref = torch.autograd.grad(ref_out, leaves, g, retain_graph=True)
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in zip(got, ref))
        errs = {n: rel_norm(x, y) for n, x, y in zip(names, got, ref)}
        worst = max(errs, key=errs.get)
        tol = REFINE_GRAD_TOL[dt]
        bwd_ms = time_ms(lambda: torch.autograd.grad(out, leaves, g,
                                                     retain_graph=True),
                         warmup=1, reps=5)
        plain_bwd_ms = time_ms(lambda: torch.autograd.grad(
            ref_out, leaves, g, retain_graph=True), warmup=1, reps=5)
        log(f"kernel ief_decode training gradient {dtn} {list(end.shape)}: "
            f"{'the same bits as' if same else 'differs from'} autograd of "
            f"ief_decode_plain; worst relative error {errs[worst]:.3g} "
            f"({worst}, tol {tol}); backward ms {bwd_ms:.4f} (autograd of "
            f"the plain decode alone {plain_bwd_ms:.4f})")
        if not (all(torch.isfinite(x).all() for x in got)
                and errs[worst] <= tol):
            raise AssertionError(f"ief_decode training gradient {dt}: "
                                 f"{worst} {errs[worst]} > {tol}")
        row["grad"][dtn] = {"same_bits": same, "max_rel_err": errs[worst],
                            "worst": worst, "tolerance_rel": tol,
                            "bwd_ms": bwd_ms, "plain_bwd_ms": plain_bwd_ms}
        del out, ref_out, got, ref
        torch.cuda.empty_cache()
    return row


def refine_train_phase(dev, profile=False):
    """Phase 13: stage-2 training behind the frozen per_ray stage 1. Returns
    K4's and K5's training rows, each with its launches per step, and the
    models, state and step for phase 17."""
    from implicit_depth_torch.config import load_config

    cfg = load_config(overrides=REFINE_OVERRIDES)
    lidf, refine = (m.to(dev) for m in build_models(cfg, train=True))
    log(f"stage-2 training model: {cfg.dataset.img_height}x"
        f"{cfg.dataset.img_width}, batch {TRAIN_BATCH} (configured "
        f"{cfg.training.batch_size}), rays {lidf.static.n_rays}, valid "
        f"{lidf.static.n_valid}, K={lidf.static.k_pairs}, "
        f"kb={cfg.tpu.pairs_budget_per_ray}, dtype {cfg.tpu.compute_dtype}, "
        f"forward_times {cfg.refine.forward_times}, perturb "
        f"{cfg.refine.perturb_prob}, {cfg.training.optimizer_name} lr "
        f"{cfg.training.lr}, pos_w {cfg.loss.pos_w}, surf_norm_w "
        f"{cfg.loss.surf_norm_w}")
    run = refine_train_path(cfg, lidf, refine, dev, TRAIN_STEPS, profile)
    k4 = add_launches(refine_k4_row(run["recorded"], dev),
                      run["launches"]["ief_decode"], TRAIN_STEPS, "step")
    k4.update(step_ms=run["step_ms"], step_device_ms=run["device_ms"],
              peak_gib=run["peak_gib"])
    k5 = add_launches(segment_train_phase(
        {k: v for k, v in run["recorded"].items() if k[0] == "segment_max0"},
        dev), run["launches"]["segment_max0"], TRAIN_STEPS, "step")
    return {"ief_decode": k4, "segment_max0": k5}, (cfg, lidf, run)


def refine_hardneg_phase(dev):
    """Phase 14: HARDNEG_STEPS refine steps with hard negatives. Returns its
    launches per step and median step_ms."""
    from implicit_depth_torch.config import load_config

    cfg = load_config(overrides=REFINE_HARDNEG_OVERRIDES)
    assert cfg.loss.hard_neg
    lidf, refine = (m.to(dev) for m in build_models(cfg, train=True))
    run = refine_train_path(cfg, lidf, refine, dev, HARDNEG_STEPS,
                            label="stage 2 hard_neg")
    return {"launches_per_step": {k: n // HARDNEG_STEPS
                                  for k, n in run["launches"].items()},
            "step_ms": run["step_ms"]}


def refine_eval_phase(dev):
    """Phase 15: the refine eval step on one 240x320 image, every pixel a
    ray, ``use_all_pix`` false (only zero-depth pixels' predictions enter
    the PointNet), in f32 on the card (one K1, two K4, ten K5) and on the
    CPU with the same weights and valid-point draw: the refined points
    within XCHECK_ATOL on all but XCHECK_FRAC of the rays."""
    from implicit_depth_torch.config import load_config
    from implicit_depth_torch.geometry.sampling import sample_valid_stratified
    from implicit_depth_torch.train.steps import make_refine_eval_step

    over = {**REFINE_OVERRIDES,
            "refine": {**REFINE_OVERRIDES["refine"], "use_all_pix": False},
            "tpu": {**REFINE_OVERRIDES["tpu"], "compute_dtype": "float32"}}
    cfg = load_config(overrides=over)
    lidf, refine = build_models(cfg)
    batch = train_batches(1, cfg, 1, "cpu")[0]
    vidx, _, _ = sample_valid_stratified(batch["depth_corrupt"] != 0,
                                         lidf.static.n_valid,
                                         torch.Generator().manual_seed(SEED))
    runs = {}
    counts = {k: f for k, f in counters().items()
              if k in EXPECT_PER_REFINE_STEP}
    for device in (dev, torch.device("cpu")):
        for f in counts.values():
            f.launches = 0
        step = make_refine_eval_step(cfg, copy.deepcopy(lidf),
                                     copy.deepcopy(refine), device)
        _, out, pred, losses = step(None, {k: v.to(device) for k, v in
                                           batch.items()}, valid_idx=vidx)
        runs[device.type] = (pred.float().cpu(), {k: v.item() for k, v in
                                                  losses.items()})
        if device == dev:
            launches = {k: f.launches for k, f in counts.items()}
    diff = (runs[dev.type][0] - runs["cpu"][0]).abs().amax(-1)
    agree = (diff <= XCHECK_ATOL).float().mean().item()
    injected = (batch["depth_corrupt"] == 0).float().mean().item()
    log(f"refine eval step f32 {dev} vs cpu ({cfg.dataset.img_height}x"
        f"{cfg.dataset.img_width}, every pixel a ray, use_all_pix false: "
        f"{injected:.3f} of the pixels injected): launches {launches}, "
        f"refined points within {XCHECK_ATOL} m: {agree:.6f}, median |diff| "
        f"{diff.median().item():.3g}, max |diff| {diff.max().item():.3g}; "
        f"losses card {runs[dev.type][1]} cpu {runs['cpu'][1]}")
    want = {k: EXPECT_PER_REFINE_STEP[k] for k in
            ("ray_decode", "ief_decode", "segment_max0")}
    if any(launches[k] != n for k, n in want.items()):
        raise AssertionError(f"refine eval step: launches {launches}, "
                             f"expected {want}")
    if agree < 1 - XCHECK_FRAC:
        raise AssertionError("refine eval step: the card and the CPU "
                             "disagree")
    return {"agree": agree, "launches": launches}


def refine_cross_check(dev):
    """Phase 16: for each seed of XCHECK_SEEDS, one f32 refine step of the
    same weights on the card (kernels) and on the CPU (plain versions),
    same valid points, ray window and perturbation: the losses within
    XCHECK_LOSS_RTOL, each refine gradient within XCHECK_GRAD_RTOL. Every
    seed is logged before a failure is raised."""
    from implicit_depth_torch.config import load_config
    from implicit_depth_torch.geometry.sampling import (
        sample_masked_window,
        sample_valid_stratified,
    )
    from implicit_depth_torch.train.state import TrainState
    from implicit_depth_torch.train.steps import make_refine_train_step

    cfg = load_config(overrides=REFINE_XCHECK)
    failed = []
    for seed in XCHECK_SEEDS:
        lidf, refine = build_models(cfg, train=True, seed=seed)
        static = lidf.static
        batch = train_batches(1, cfg, 1, "cpu", seed)[0]
        gen = torch.Generator().manual_seed(seed)
        vidx, _, _ = sample_valid_stratified(batch["valid_mask"] > 0.5,
                                             static.n_valid, gen)
        _, _, _, mstart = sample_masked_window(
            (batch["corrupt_mask"] > 0.5).reshape(1, -1), static.n_rays, gen)
        noise = {k: torch.rand((1,), generator=gen)
                 for k in ("apply", "bucket", "u")}
        runs = {}
        for device in (dev, torch.device("cpu")):
            lm, rm = copy.deepcopy(lidf), copy.deepcopy(refine)
            state = TrainState.create(rm, cfg.training, steps_per_epoch=1000)
            losses = make_refine_train_step(cfg, lm, rm, device)(
                state, {k: v.to(device) for k, v in batch.items()}, None, 0,
                valid_idx=vidx, miss_start=mstart,
                noise={k: v.to(device) for k, v in noise.items()})
            runs[device.type] = ({k: v.item() for k, v in losses.items()},
                                 {n: p.grad.cpu()
                                  for n, p in rm.named_parameters()})
        (la, ga), (lb, gb) = runs[dev.type], runs["cpu"]
        loss_err = max(abs(la[k] - lb[k]) / max(abs(lb[k]), 1e-6) for k in lb)
        errs = {n: rel_norm(ga[n], gb[n]) for n in gb}
        worst = max(errs, key=errs.get)
        log(f"refine cross-check f32 seed {seed}, card vs cpu "
            f"({cfg.dataset.img_height}x{cfg.dataset.img_width}, "
            f"{static.n_rays} rays, perturbation {noise}): losses card {la} "
            f"cpu {lb}; largest relative loss difference {loss_err:.3g}; "
            f"gradients, largest relative error {errs[worst]:.3g} ({worst}), "
            f"median {statistics.median(errs.values()):.3g}")
        if loss_err > XCHECK_LOSS_RTOL:
            failed.append(f"seed {seed} losses: {loss_err}")
        if errs[worst] > XCHECK_GRAD_RTOL:
            failed.append(f"seed {seed} {worst}: {errs[worst]}")
    if failed:
        raise AssertionError(f"refine cross-check: the card and the CPU "
                             f"disagree: {failed}")


def checkpoint_phase(dev, cfg, lidf, run):
    """Phase 17: checkpoints on the card. Phase 13's stage 1 and refine
    state saved; ``DepthCompleter.from_checkpoint`` of them serves a
    480x640 frame bit for bit as the in-memory pair; the refine state
    restored into fresh models takes one more step bit for bit as the
    uninterrupted state does (same batch, same draws)."""
    import os
    import tempfile

    from implicit_depth_torch.builder import build_refine
    from implicit_depth_torch.infer import DepthCompleter
    from implicit_depth_torch.train.checkpoint import Checkpointer
    from implicit_depth_torch.train.state import TrainState
    from implicit_depth_torch.train.steps import make_refine_train_step

    state, step, batch = run["state"], run["step"], run["batches"][1]
    frame = make_frames(1, FRAME_HW)[0]
    with tempfile.TemporaryDirectory() as d:
        lidf_dir, refine_dir = os.path.join(d, "lidf"), os.path.join(d, "refine")
        Checkpointer(lidf_dir).save(lidf, epoch=0)
        Checkpointer(refine_dir).save(state, epoch=0, meta={"phase": 13})
        want = DepthCompleter(cfg, lidf=lidf, refine=state.model,
                              device=dev).complete(*frame)
        dc = DepthCompleter.from_checkpoint(lidf_dir, refine_dir, cfg=cfg,
                                            device=dev)
        got = dc.complete(*frame)
        same_frame = all(got[k].tobytes() == want[k].tobytes()
                         for k in ("depth", "depth_pred"))
        fresh = TrainState.create(build_refine(cfg, lidf.static).to(dev),
                                  cfg.training, steps_per_epoch=1000)
        fresh, meta = Checkpointer(refine_dir).restore(fresh)
    resumed = make_refine_train_step(cfg, lidf, fresh.model, dev)
    outs = []
    for st, fn in ((state, step), (fresh, resumed)):
        gen = torch.Generator(device=dev).manual_seed(SEED + 7)
        outs.append({k: v.item() for k, v in fn(st, batch, gen, 1).items()})
    same_losses = outs[0] == outs[1]
    differ = [n for (n, p), q in zip(state.model.named_parameters(),
                                     fresh.model.parameters())
              if not torch.equal(p, q)]
    log(f"checkpoints: a 480x640 frame from DepthCompleter.from_checkpoint "
        f"{'is' if same_frame else 'is NOT'} bit for bit the in-memory "
        f"pair's; restored refine state (step {fresh.step}, meta {meta}): "
        f"one more step gives losses {outs[1]} against the uninterrupted "
        f"{outs[0]} ({'the same bits' if same_losses else 'different'}), "
        f"parameters differing: {differ}")
    if not (same_frame and same_losses and not differ):
        raise AssertionError("checkpoints: the restored models do not give "
                             "the bits of the in-memory ones")
    return {"frame_bit_identical": same_frame, "resume_bit_identical": True}


def refine_phases(dev, profile=False):
    """Phases 13-17 (see the module doc). Returns K4's and K5's stage-2
    training rows."""
    rows, (cfg, lidf, run) = refine_train_phase(dev, profile)
    rows["ief_decode"]["hard_neg"] = refine_hardneg_phase(dev)
    rows["ief_decode"]["eval"] = refine_eval_phase(dev)
    refine_cross_check(dev)
    rows["ief_decode"]["checkpoint"] = checkpoint_phase(dev, cfg, lidf, run)
    del run, lidf
    torch.cuda.empty_cache()
    return rows


def add_launches(row, n, runs, unit):
    """``row`` with its kernel's ``n`` launches in a main path of ``runs``
    frames or steps (``unit``)."""
    row.update({"launches": n, f"launches_per_{unit}": n // runs})
    return row


# what the kernels line copies from each kernel's row
ENTRY_KEYS = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
              "bound_by", "library_ms", "dtype", "shape", "tolerance",
              "typical_abs", "max_rel_err", "worst", "tolerance_rel",
              "launches_per_frame", "launches_per_step", "train", "modes",
              "kernel_device_ms", "library_device_ms", "device_ops_per_call",
              "by_shape", "passes", "step_ms", "save_bytes", "train_xla",
              "rows_decoded", "ptxas", "refine_train")


def run(dev, overrides=SERVE_OVERRIDES, frame_hw=FRAME_HW, profile=False,
        train_overrides=TRAIN_OVERRIDES):
    """Phases 2-17 on ``dev``; prints the kernels line."""
    from implicit_depth_torch.builder import (
        build_lidf,
        build_static,
        randomize_weights_,
    )
    from implicit_depth_torch.config import load_config
    from implicit_depth_torch.infer import DepthCompleter

    build_phase()
    # random weights from a seed, redrawn at unit activation scale so that
    # every comparison below sees decoder outputs spread over (0, 1)
    cfg = load_config(overrides=overrides)
    lidf, refine = build_models(cfg)
    static = lidf.static
    lidf_cpu, refine_cpu = copy.deepcopy(lidf), copy.deepcopy(refine)
    dc = DepthCompleter(cfg, lidf=lidf, refine=refine, device=dev)
    log(f"model: {cfg.dataset.img_height}x{cfg.dataset.img_width}, "
        f"K={static.k_pairs}, kb={cfg.tpu.pairs_budget_per_ray}, "
        f"valid={static.n_valid}, dtype={cfg.tpu.compute_dtype}, "
        f"forward_times={cfg.refine.forward_times}")
    frames = make_frames(MAIN_FRAMES + 1, frame_hw)

    rows = kernel_phase(record_calls(kernel_modules(),
                                   lambda: dc.complete(*frames[0])),
                      lidf, refine, dev)
    launches, _ = main_path(dc, frames[1:], cfg)
    for name, n in launches.items():
        add_launches(rows[name], n, MAIN_FRAMES, "frame")
    if profile:
        profile_device_ms(lambda: dc.complete(*frames[1]),
                          "main path: device time of one frame")
    cross_check(overrides, lidf_cpu, refine_cpu, frames[1], dev)
    del dc, lidf, refine, lidf_cpu, refine_cpu
    torch.cuda.empty_cache()

    # -- stage-1 training ------------------------------------------------------
    cfg_t = load_config(overrides=train_overrides)
    static_t = build_static(cfg_t)
    gen = torch.Generator().manual_seed(SEED + 1)
    model = randomize_weights_(build_lidf(cfg_t, static_t, gen), gen).to(dev)
    log(f"training model: {cfg_t.dataset.img_height}x"
        f"{cfg_t.dataset.img_width}, batch {TRAIN_BATCH} (configured "
        f"{cfg_t.training.batch_size}), rays {static_t.n_rays}, valid "
        f"{static_t.n_valid}, K={static_t.k_pairs}, "
        f"kb={cfg_t.tpu.pairs_budget_per_ray}, dtype "
        f"{cfg_t.tpu.compute_dtype}, decode_bwd {cfg_t.tpu.decode_bwd}, "
        f"{cfg_t.training.optimizer_name} lr {cfg_t.training.lr}")
    recorded, launches_t, step_ms = train_path(cfg_t, model, dev, profile)
    train_rows = train_kernel_phase(recorded)
    train_rows["segment_max0"] = segment_train_phase(
        recorded["segment_max0"], dev)
    for name, n in launches_t.items():
        add_launches(train_rows[name], n, TRAIN_STEPS, "step")
    rows["segment_max0"]["train"] = train_rows.pop("segment_max0")
    train_rows["ray_decode_bwd"]["step_ms"] = statistics.median(step_ms)
    rows.update(train_rows)
    del recorded, model
    torch.cuda.empty_cache()
    train_cross_check(dev)

    # -- the global and dense decode modes (K6) ------------------------------
    rows["pair_decode"] = pair_modes_phase(dev, overrides, frame_hw, profile)
    # -- stage-1 training with decode_bwd: kernel ------------------------------
    rows["ray_decode"]["train"], rows["ray_decode_bwd_recompute"] = \
        train_kernel_variant_phase(dev, train_overrides, profile)
    # -- stage-1 training with decode_bwd: kernel_save_all and xla -----------
    rows.update(train_save_all_phase(dev, train_overrides, profile))
    rows["ray_decode"]["train_xla"] = train_xla_phase(dev, train_overrides,
                                                      profile)
    # -- stage-2 training, its eval step, checkpoints ------------------------
    refine_rows = refine_phases(dev, profile)
    rows["ief_decode"]["refine_train"] = refine_rows["ief_decode"]
    rows["segment_max0"]["refine_train"] = refine_rows["segment_max0"]
    log(f"step medians in this run: decode_bwd kernel_save "
        f"{rows['ray_decode_bwd']['step_ms']} ms, kernel "
        f"{rows['ray_decode_bwd_recompute']['step_ms']} ms, kernel_save_all "
        f"{rows['ray_decode_bwd_all']['step_ms']} ms, xla "
        f"{rows['ray_decode']['train_xla']['step_ms']} ms; stage 2 "
        f"{refine_rows['ief_decode']['step_ms']} ms, hard_neg "
        f"{refine_rows['ief_decode']['hard_neg']['step_ms']} ms")

    kernels = [{"name": name, "route": "cuda", "source": SOURCES[name][0],
                "replaces": SOURCES[name][1],
                **{k: row[k] for k in ENTRY_KEYS if k in row}}
               for name, row in sorted(rows.items())]
    uncounted = [e["name"] for e in kernels if "launches" not in e]
    if uncounted:
        raise AssertionError(f"kernels with no main-path launches: {uncounted}")
    log(json.dumps({"kernels": kernels}))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true",
                    help="print torch.profiler tables of one served frame "
                    "and of one train step in each decode_bwd mode and of "
                    "one stage-2 step")
    args = ap.parse_args()

    # -- 1. device -------------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log("torch", torch.__version__, "cuda", torch.version.cuda)
    # f32 results are compared: no TF32 in convolutions or products
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    run(torch.device("cuda"), profile=args.profile)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
