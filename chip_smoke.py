"""Chip smoke test of the PyTorch/CUDA port (``implicit_depth_torch``) on one
NVIDIA GPU: builds the CUDA kernels, holds each against its plain PyTorch
version at the serving shapes, serves synthetic frames through the port's
two-stage ``DepthCompleter`` at the full default width, and cross-checks one
frame against the plain CPU path.

    python3 chip_smoke.py             # every phase; exits 0 only if all pass
    python3 chip_smoke.py --profile   # also a torch.profiler table of a frame

Phases:
  1. device: a CUDA device must be present; prints name and power limit;
  2. build: nvcc builds csrc/*.cu (into build/idt_torch_kernels/);
  3. kernels: K1 ray_decode, K4 ief_decode, K5 segment_max0 on the inputs the
     main path gives them (recorded from a warm-up frame), in bf16 and f32:
     max |kernel - plain| against a stated tolerance that lies well below
     the spread of the outputs (the weights are redrawn at unit activation
     scale), and median times of the kernel, its plain version and (K5) the
     library yardstick;
  4. main path: 5 frames of 480x640 through DepthCompleter.complete on the
     card (launch counters from 0: K1 1, K4 2, K5 10 per frame), finite output,
     input depth passed through bit for bit; median ms per frame;
  5. cross-check: one frame in f32 on the card (kernels) and on the CPU
     (plain versions), same weights and valid-point draw.
The next-to-last line is {"kernels": [...]}; the last is
{"ok": true, "device": {...}}. Any failure raises: no phase is caught.
"""

from __future__ import annotations

import argparse
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
SOURCES = {"ray_decode": ("implicit_depth_torch/csrc/ray_decode.cu",
                          "implicit_depth_tpu/ops/pallas_ray_decode.py:357"),
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


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if torch.is_tensor(t))


def bound(name, a, dt):
    """(bound_ms, bound_by, flops, bytes) of one call on these inputs: each
    input read once, each output written once, the operations at the peak
    rate of the units that do them."""
    if name == "ray_decode":
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
        peak = PEAK_TC[dt]
    elif name == "ief_decode":
        e, rc, p, w = a
        n = e.shape[0]
        flops = 2 * n * ((e.shape[1] + rc.shape[1] + p.shape[1]) * 256
                         + 2 * (256 * 128 + 128 * 64 + 64))
        byt = nbytes(e, rc, p, *w.values()) + n * 4
        peak = PEAK_TC[dt]
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
        if "registers" in line or "spill" in line or "error" in line:
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
    """(module, attribute) of each kernel wrapper as the main path calls it."""
    from implicit_depth_torch.models import lidf, pointnet, refine
    return {"ray_decode": (lidf, "ray_decode"), "ief_decode": (refine, "ief_decode"),
            "segment_max0": (pointnet, "segment_max0")}


def record_kernel_calls(dc, frame):
    """Serve ``frame`` once; returns {(name, shapes): (args, kwargs)} of each
    kernel wrapper's first call per input shape."""
    recorded = {}
    mods = kernel_modules()
    originals = {name: getattr(m, attr) for name, (m, attr) in mods.items()}

    def recorder(name):
        def call(*a, **kw):
            shape = tuple(tuple(t.shape) for t in a if torch.is_tensor(t))
            recorded.setdefault((name, shape), (a, kw))
            return originals[name](*a, **kw)
        return call

    for name, (m, attr) in mods.items():
        setattr(m, attr, recorder(name))
    try:
        dc.complete(*frame)
    finally:
        for name, (m, attr) in mods.items():
            setattr(m, attr, originals[name])
    torch.cuda.synchronize()
    return recorded


@torch.inference_mode()
def kernel_phase(recorded, lidf, refine, dev):
    """Each recorded call in bf16 (as recorded) and f32: kernel vs plain,
    times, bound. Returns the row of each kernel at its largest bf16 shape."""
    from implicit_depth_torch.models.lidf import decoder_weights
    from implicit_depth_torch.ops import ray_decode as rd
    from implicit_depth_torch.ops import segment

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
        d, ids, ns, v = a
        return d.float(), ids, ns, v

    mods = kernel_modules()
    plain = {"ray_decode": rd.ray_decode_plain, "ief_decode": rd.ief_decode_plain,
             "segment_max0": segment.segment_max0_plain}
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
            tol = TOL[(name, dt)]
            ok = err <= tol and all(torch.isfinite(g).all() for g in got)
            ms = time_ms(lambda: kern(*a, **kw))
            plain_ms = time_ms(lambda: plain[name](*a, **kw))
            lib_ms = None
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
            b_ms, b_by, flops, byt = bound(name, a, dt)
            row = {"name": name, "dtype": str(dt).split(".")[-1],
                   "shape": [list(s) for s in shape], "max_abs_err": err,
                   "tolerance": tol, "typical_abs": typical,
                   "spread": spread, "ms": ms, "plain_ms": plain_ms,
                   "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
                   "flops": flops, "bytes": byt}
            log(f"kernel {name} {row['dtype']} {row['shape']}: "
                f"max_abs_err {err:.3g} (tol {tol}; outputs: mean |y| "
                f"{typical:.3g}, std {spread:.3g}) ms {ms:.4f} "
                f"plain_ms {plain_ms:.4f} library_ms {lib_ms} "
                f"bound_ms {b_ms:.4f} ({b_by})")
            if not ok:
                raise AssertionError(f"{name} {dt}: kernel disagrees with its "
                                     f"plain version: {err} > {tol}")
            if BITE * tol > spread:
                raise AssertionError(f"{name} {dt}: tolerance {tol} is not "
                                     f"{BITE}x below the outputs' spread "
                                     f"{spread}")
            # the JSON line carries the main path's dtype at its largest shape
            if dt == torch.bfloat16:
                size = shape[0][0] * (shape[0][1] if len(shape[0]) > 1 else 1)
                if name not in entries or size >= entries[name][0]:
                    entries[name] = (size, row)
    if set(entries) != set(EXPECT_PER_FRAME):
        raise AssertionError(f"kernels measured: {sorted(entries)}")
    return {name: row for name, (_, row) in entries.items()}


def main_path(dc, frames, cfg):
    """Serve ``frames`` with every launch counter from 0; returns the
    launches."""
    from implicit_depth_torch.ops import ray_decode as rd
    from implicit_depth_torch.ops import segment
    counters = {"ray_decode": rd.ray_decode, "ief_decode": rd.ief_decode,
                "segment_max0": segment.segment_max0}
    for f in counters.values():
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
    launches = {k: f.launches for k, f in counters.items()}
    log(f"main path: {len(frames)} frames {frames[0][1].shape[0]}x"
        f"{frames[0][1].shape[1]}, launches {launches}, "
        f"frame_ms {frame_ms}, median frame_ms {statistics.median(frame_ms)}")
    for k, per in EXPECT_PER_FRAME.items():
        if launches[k] != per * len(frames):
            raise AssertionError(f"{k}: {launches[k]} launches in "
                                 f"{len(frames)} frames, expected "
                                 f"{per} per frame")
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches


def cross_check(overrides, lidf_cpu, refine_cpu, frame, dev):
    """One frame in f32 through the same weights on ``dev`` (kernels) and on
    the CPU (plain versions), with the same valid-point draw."""
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


def run(dev, overrides=SERVE_OVERRIDES, frame_hw=FRAME_HW, profile=False):
    """Phases 2-6 on ``dev``; prints the kernels line."""
    from implicit_depth_torch.builder import (
        build_lidf,
        build_refine,
        build_static,
        randomize_weights_,
    )
    from implicit_depth_torch.config import load_config
    from implicit_depth_torch.infer import DepthCompleter

    build_phase()
    # random weights from a seed, redrawn at unit activation scale so that
    # every comparison below sees decoder outputs spread over (0, 1)
    cfg = load_config(overrides=overrides)
    static = build_static(cfg, n_rays=cfg.dataset.img_height * cfg.dataset.img_width)
    gen = torch.Generator().manual_seed(SEED)
    lidf = randomize_weights_(build_lidf(cfg, static, gen), gen)
    refine = randomize_weights_(build_refine(cfg, static, gen), gen)
    lidf_cpu, refine_cpu = copy.deepcopy(lidf), copy.deepcopy(refine)
    dc = DepthCompleter(cfg, lidf=lidf, refine=refine, device=dev)
    log(f"model: {cfg.dataset.img_height}x{cfg.dataset.img_width}, "
        f"K={static.k_pairs}, kb={cfg.tpu.pairs_budget_per_ray}, "
        f"valid={static.n_valid}, dtype={cfg.tpu.compute_dtype}, "
        f"forward_times={cfg.refine.forward_times}")
    frames = make_frames(MAIN_FRAMES + 1, frame_hw)

    rows = kernel_phase(record_kernel_calls(dc, frames[0]), lidf, refine, dev)
    launches = main_path(dc, frames[1:], cfg)
    if profile:
        from torch.profiler import ProfilerActivity, profile as prof_ctx
        with prof_ctx(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            dc.complete(*frames[1])
            torch.cuda.synchronize()
        log(prof.key_averages().table(sort_by="cuda_time_total", row_limit=30))
    cross_check(overrides, lidf_cpu, refine_cpu, frames[1], dev)

    kernels = []
    for name, row in sorted(rows.items()):
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name][0],
            "replaces": SOURCES[name][1], "launches": launches[name],
            "max_abs_err": row["max_abs_err"], "tolerance": row["tolerance"],
            "typical_abs": row["typical_abs"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "dtype": row["dtype"], "shape": row["shape"],
            "launches_per_frame": launches[name] // MAIN_FRAMES})
    log(json.dumps({"kernels": kernels}))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true",
                    help="print a torch.profiler table of one served frame")
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
