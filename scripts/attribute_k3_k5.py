"""Split the device time of K3 (the fused decode backward) and K5 (the voxel
max-pool) among their costs, on one NVIDIA GPU.

    mkdir -p build/pr3tree && git archive 58e9e21 | tar -x -C build/pr3tree
    cp scripts/attribute_k3_k5.py build/pr3tree/scripts/
    cd build/pr3tree && python3 scripts/attribute_k3_k5.py \
        --src implicit_depth_torch/csrc --out ../attribution.json

``--src`` is a ``csrc`` directory whose ``ray_decode_bwd.cu`` and
``segment_max.cu`` have the C interface of the per-block-workspace K3 and the
single-table K5 (``implicit_depth_torch`` before their redesign, as at commit
58e9e21); run it from a checkout of that tree, so that the inputs it records
come from the same code. It records the inputs of one stage-1 train step
(batch 4, 240x320, bf16) and of one served 480x640 frame with
``chip_smoke``'s helpers, then:

* K3, both instances (from K2's saves; recomputing layer 1): builds the
  source as it is and in measurement variants, each with one cost skipped
  (outputs wrong, time only), and times each on the recorded inputs:
  ``wgrad`` (the weight-gradient workspace: the per-tile accumulator loads
  and stores and the slice reduction), ``products`` (every product with
  weights read from global memory: the tails, the input gradients, the
  per-ray layer 1, d_ray_feat, d_rows), ``serial`` (the column sums, the
  layer-4 weight gradient and the IEF offset dots between
  ``__syncthreads``), ``atomics`` (the d_vox_table ``atomicAdd``), and all
  four at once (what is left: staging, elementwise passes, loads);
* K5 at the serving shape and both training shapes, bf16 and f32: the bare
  kernel's device time (``torch.profiler``, 100 launches into one zeroed
  table), the wrapper's time (one call between CUDA events, as
  ``chip_smoke`` times it) and the ``scatter_reduce_`` yardstick.

The redesigned K3 (Pass A / Pass B) is timed pass by pass by
``chip_smoke.py``, from CUDA events its C function records between its
launches.

Writes ``build/attribution.json`` (``--out``) and prints a summary.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from implicit_depth_torch.ops import cuda  # noqa: E402
from implicit_depth_torch.ops import ray_decode as rd  # noqa: E402

# (anchor, replacement) edits of the measurement variants; IDT_SKIP's bits:
# 1 wgrad, 2 products, 4 serial passes, 8 atomics
K3_EDITS = [
    ("int N, float* G, int ldg) {",
     "int N, float* G, int ldg) {\n  if (IDT_SKIP & 1) return;"),
    ("  const long long grid = (p.slice + kThreads - 1) / kThreads;",
     "  if (IDT_SKIP & 1) return 0;\n"
     "  const long long grid = (p.slice + kThreads - 1) / kThreads;"),
    ("int M, int K, int N, float* C, int ldc, bool acc) {",
     "int M, int K, int N, float* C, int ldc, bool acc) {\n"
     "  if (IDT_SKIP & 2) return;"),
    ("const float* X, int ldx, int M, int N, float* g) {",
     "const float* X, int ldx, int M, int N, float* g) {\n"
     "  if (IDT_SKIP & 4) return;"),
    ("  for (int c = threadIdx.x; c <= kG3; c += blockDim.x) {",
     "  if (!(IDT_SKIP & 4)) for (int c = threadIdx.x; c <= kG3; "
     "c += blockDim.x) {"),
    ("    if (off_i != nullptr) {",
     "    if (off_i != nullptr && !(IDT_SKIP & 4)) {"),
    ("        atomicAdd(p.d_table + cell * c_vox + col, D[i]);",
     "        if (!(IDT_SKIP & 8)) "
     "atomicAdd(p.d_table + cell * c_vox + col, D[i]);"),
]
COMMON_EDITS = [
    ("                         float* C, int ldc) {\n  using namespace nvcuda;",
     "                         float* C, int ldc) {\n"
     "  if (IDT_SKIP & 2) return;\n  using namespace nvcuda;"),
    ("int K, int N, float* C, int ldc) {\n  const int col_groups = N / 4;",
     "int K, int N, float* C, int ldc) {\n  if (IDT_SKIP & 2) return;\n"
     "  const int col_groups = N / 4;"),
]
VARIANTS = {"as is": 0, "wgrad": 1, "products": 2, "serial": 4,
            "atomics": 8, "all four": 15}


def edit(text, edits, what):
    for old, new in edits:
        if text.count(old) < 1:
            raise ValueError(f"{what}: anchor not found: {old!r}")
        text = text.replace(old, new)
    return "#ifndef IDT_SKIP\n#define IDT_SKIP 0\n#endif\n" + text


def build_variants(src: Path, out: Path):
    """One library per K3 variant and one of K5, all nvcc runs at once."""
    out.mkdir(parents=True, exist_ok=True)
    (out / "ray_decode_bwd.cu").write_text(
        edit((src / "ray_decode_bwd.cu").read_text(), K3_EDITS, "K3"))
    (out / "decode_common.cuh").write_text(
        edit((src / "decode_common.cuh").read_text(), COMMON_EDITS, "common"))
    shutil.copy(src / "segment_max.cu", out / "segment_max.cu")
    nvcc = cuda._nvcc()
    jobs = {f"k3_{bits}": (out / "ray_decode_bwd.cu", [f"-DIDT_SKIP={bits}"])
            for bits in VARIANTS.values()}
    jobs["k5"] = (out / "segment_max.cu", [])
    procs = {name: subprocess.Popen(
        [nvcc, *cuda.NVCC_FLAGS, *flags, "-I", str(out), "-o",
         str(out / f"lib{name}.so"), str(path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, (path, flags) in jobs.items()}
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(out / f"lib{name}.so"))
    return libs


def k3_call(lib, a, saved, kw):
    """A closure that runs the workspace K3 of ``lib`` on the operands
    ``a`` = (vox_table, cells, pos, ray_feat, w, _, g_off, g_logit), as its
    wrapper did (workspace zeroed, e1 scratch for the recompute instance)."""
    vt, cells, pos, rf, w = a[:5]
    g_off, g_logit = a[6], a[7]
    vt, cells, pos, rf = rd.check_operands("k3", vt, cells, pos, rf, w)
    dtype = w["pair_w1"].dtype
    n = cells.shape[0]
    c_vox, c_ray, multires = w["dims"]
    kp, crp = w["pair_w1"].shape[0], w["ray_w1"].shape[0]
    layout = (cuda.I64 * 18)()
    fn_l = lib.idt_ray_decode_bwd_layout
    fn_l.argtypes = [cuda.I64, cuda.I64, cuda.PTR, cuda.PTR]
    fn_l(kp, crp, ctypes.addressof(layout), None)
    slice_floats = layout[17]
    dev = cells.device
    blocks = max(1, min(cuda.sm_count(dev),
                        -(-n // (8 if dtype == torch.bfloat16 else 4))))
    g = torch.stack([g_off.float(), g_logit.float()], -1).contiguous()
    saved = (None,) * 3 if saved is None else saved
    scratch = None if saved[0] is not None else torch.empty(
        (blocks, 64 if dtype == torch.bfloat16 else 32, 256),
        dtype=torch.float32, device=dev)
    d_w = torch.empty((slice_floats,), dtype=torch.float32, device=dev)
    d_rf = torch.empty((n, c_ray), dtype=torch.float32, device=dev)
    fn = lib.idt_ray_decode_bwd
    fn.argtypes = [cuda.PTR, *[cuda.I64] * 10, cuda.F32, cuda.PTR]
    fn.restype = ctypes.c_int

    def call():
        work = torch.zeros((blocks, slice_floats), dtype=torch.float32,
                           device=dev)
        d_table = torch.zeros(vt.shape, dtype=torch.float32, device=dev)
        ptrs = cuda.ptr_array([vt, cells, pos, rf,
                               *(w[k] for k in rd.FORMAT.operands), *saved, g,
                               d_table, d_rf, work, d_w, scratch])
        cuda.check(fn(ptrs, n, c_vox, c_ray, multires, kp, crp,
                      kw.get("n_iter", 2), int(dtype == torch.bfloat16),
                      int(kw.get("use_sigmoid", False)), blocks,
                      kw.get("init_offset", 0.001), cuda.stream_ptr(dev)),
                   "k3 variant")
    return call, (blocks, slice_floats)


def k3_attribution(libs, rec):
    (vt, cells, pos, rf, w, saved, g_off, g_logit), kw = \
        rec["ray_decode_bwd"]
    out = {}
    for inst, sv in (("kernel_save", saved), ("kernel", None)):
        times = {}
        for label, bits in VARIANTS.items():
            call, (blocks, slice_floats) = k3_call(
                libs[f"k3_{bits}"], (vt, cells, pos, rf, w, None, g_off,
                                     g_logit), sv, kw)
            times[label] = cs.time_ms(call, warmup=1, reps=5)
        zeros_ms = cs.time_ms(lambda: torch.zeros(
            (blocks, slice_floats), dtype=torch.float32, device=cells.device))
        base = times["as is"]
        out[inst] = {"ms": times, "workspace_zeros_ms": zeros_ms,
                     "share": {k: (base - v) / base for k, v in times.items()
                               if k != "as is"},
                     "workspace_bytes": blocks * slice_floats * 4,
                     "blocks": blocks, "rows": int(cells.numel())}
        cs.log(f"K3 {inst} bf16 {list(cells.shape)}: "
               + ", ".join(f"{k} {v:.3f} ms" for k, v in times.items())
               + f"; workspace zeros {zeros_ms:.3f} ms")
        cs.log("  share of the time each skip removes: " + ", ".join(
            f"{k} {v:.1%}" for k, v in out[inst]["share"].items()))
    return out


def profile_device_ms(fn, reps, name_part):
    """Mean device time of the kernels whose name holds ``name_part`` over
    ``reps`` calls of ``fn`` (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total, count, others = 0.0, 0, {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = ev.cuda_time_total
        if name_part in ev.key:
            total += t
            count += ev.count
        elif t > 0:
            others[ev.key] = (t / reps / 1e3, ev.count / reps)
    return (total / count / 1e3 if count else None), others


def k5_attribution(lib, calls, dev):
    fn = lib.idt_segment_max
    fn.argtypes = [*[cuda.PTR] * 4, *[cuda.I64] * 4, cuda.PTR]
    fn.restype = ctypes.c_int
    out = []
    for d0, ids, ns, v in calls:
        for dt in (torch.bfloat16, torch.float32):
            d = d0.to(dt).contiguous()
            n, c = d.shape
            ids32 = ids.to(torch.int32).contiguous()
            vm = None if v is None else v.to(torch.uint8).contiguous()
            table = torch.zeros((ns, c), dtype=torch.float32, device=dev)

            def bare():
                cuda.check(fn(d.data_ptr(), ids32.data_ptr(), cuda.ptr(vm),
                              table.data_ptr(), n, c, ns,
                              int(dt == torch.bfloat16),
                              cuda.stream_ptr(dev)), "k5")
            kernel_ms, _ = profile_device_ms(bare, 100, "segment_max")
            fns = {"segment_max": fn}

            def wrap():
                # what the single-table wrapper did around its kernel: the
                # uint8 copy of valid, the zeroed f32 table, the function's
                # lookup, the launch, the cast back to the data's dtype
                vmask = None if v is None else v.to(torch.uint8).contiguous()
                tab = torch.zeros((ns, c), dtype=torch.float32, device=dev)
                cuda.check(fns["segment_max"](
                    d.data_ptr(), ids.to(torch.int32).contiguous().data_ptr(),
                    cuda.ptr(vmask), tab.data_ptr(), n, c, ns,
                    int(dt == torch.bfloat16), cuda.stream_ptr(dev)), "k5")
                return tab.to(dt)
            wrapper_ms = cs.time_ms(wrap)
            _, wrapper_kernels = profile_device_ms(wrap, 100, "segment_max")
            src = d if v is None else torch.where(
                v[:, None], d, torch.zeros((), dtype=dt, device=dev))
            idx = ids.long()[:, None].expand_as(d)
            lib_table = torch.zeros((ns, c), dtype=dt, device=dev)
            library_ms = cs.time_ms(
                lambda: lib_table.scatter_reduce_(0, idx, src, "amax"))
            lib_dev_ms, _ = profile_device_ms(
                lambda: lib_table.scatter_reduce_(0, idx, src, "amax"), 100,
                "scatter")
            row = {"shape": [n, c], "segments": ns,
                   "dtype": str(dt).split(".")[-1], "kernel_device_ms":
                   kernel_ms, "wrapper_ms": wrapper_ms,
                   "wrapper_other_kernels": wrapper_kernels,
                   "library_ms": library_ms,
                   "library_device_ms": lib_dev_ms}
            out.append(row)
            cs.log(f"K5 {row['dtype']} {n}x{c} -> {ns}: bare kernel "
                   f"{kernel_ms} ms (device), wrapper {wrapper_ms:.4f} ms, "
                   f"scatter_reduce_ {library_ms:.4f} ms (device "
                   f"{lib_dev_ms}); the wrapper's other kernels per call "
                   f"{wrapper_kernels}")
    return out


def record_inputs(dev):
    """(K3's recorded train call, K5's calls at the serving and training
    shapes) from one train step and one served frame."""
    from implicit_depth_torch.builder import (
        build_lidf,
        build_static,
        randomize_weights_,
    )
    from implicit_depth_torch.config import load_config
    from implicit_depth_torch.infer import DepthCompleter
    from implicit_depth_torch.train.state import TrainState
    from implicit_depth_torch.train.steps import make_lidf_train_step

    cfg = load_config(overrides=cs.SERVE_OVERRIDES)
    lidf, refine = cs.build_models(cfg)
    dc = DepthCompleter(cfg, lidf=lidf, refine=refine, device=dev)
    frame = cs.make_frames(1, cs.FRAME_HW)[0]
    served = cs.record_calls(
        {"segment_max0": cs.kernel_modules()["segment_max0"]},
        lambda: dc.complete(*frame))
    big = max(served.values(), key=lambda c: c[0][0].numel())[0]
    del dc, lidf, refine
    cfg_t = load_config(overrides=cs.TRAIN_OVERRIDES)
    gen = torch.Generator().manual_seed(cs.SEED + 1)
    model = randomize_weights_(build_lidf(cfg_t, build_static(cfg_t), gen),
                               gen).to(dev)
    state = TrainState.create(model, cfg_t.training, steps_per_epoch=1000)
    step = make_lidf_train_step(cfg_t, model, dev)
    batch = cs.train_batches(1, cfg_t, cs.TRAIN_BATCH, dev)[0]
    rec = cs.record_train_calls(step, state, batch,
                                torch.Generator(device=dev).manual_seed(0))
    k5 = [tuple(big)] + [a for (a, _) in rec["segment_max0"].values()]
    return rec, [(d.detach(), ids, ns, v) for d, ids, ns, v in k5]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", required=True, type=Path,
                    help="csrc directory of the kernels to attribute")
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "attribution.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("attribute_k3_k5: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    cs.log(smi)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    libs = build_variants(args.src, ROOT / "build" / "attribution")
    rec, k5_calls = record_inputs(dev)
    with torch.no_grad():
        k3 = k3_attribution(libs, rec)
        k5 = k5_attribution(libs["k5"], k5_calls, dev)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"device": smi, "k3": k3, "k5": k5},
                                   indent=1, default=str))
    cs.log(f"wrote {args.out}")


if __name__ == "__main__":
    main()
