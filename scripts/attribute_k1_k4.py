"""Split the device time of K1/K2 (the stage-1 ray decode,
``csrc/ray_decode.cu``) and K4 (the stage-2 IEF decode, ``csrc/ief_decode.cu``)
among their costs, on one NVIDIA GPU.

    python3 scripts/attribute_k1_k4.py [--out build/k1_k4.json]
        [--variants "products,input staging"] [--baseline DIR]

Records the inputs of K1 and K4 from one served 480x640 frame and of K2 from
one stage-1 train step (batch 4, 240x320), bf16, with ``chip_smoke``'s
helpers, then times each kernel on them (median of CUDA-event times, as
``chip_smoke`` times them), as built and in measurement builds with one
cost skipped each (outputs wrong, time only). The costs depend on the
version of the sources (``EDITS``, chosen by the files in ``csrc/``):

* the first kernels (``decode_common.cuh``'s wmma ``mma_tile``, one block
  per SM; the sources of commit eb00f19):
  ``products`` (every tensor-core product: its weight fragments read from
  L2, the mma, the f32 store), ``weights from L2`` (every k-step reads the
  first k-step's weight fragments: what is left of the products without
  their L2 traffic), ``C round trips`` (the f32 stores of each product into
  shared memory and the elementwise passes that read them back; K2's e1
  and z1p saves go with them), ``per-ray FMA`` (K1's per-ray layer-1 part
  on the CUDA cores), ``input staging`` (the 2-byte loads of the voxel rows,
  positions, trig and ray features, K4's three row tensors; K2's trig saves
  go with them), and ``all`` four but the weights-from-L2 variant;
* the redesign (``decode_tile.cuh``): ``products`` (every staged product:
  the slab copies and the mma), ``weight slabs`` (the cp.async copies of
  the weights alone), ``epilogues`` (bias, LeakyReLU, rounding and stores
  of every product's accumulators; K2's saves go with them), ``input
  staging`` (the 16-byte loads and the trig block), and ``all``.

Each build is its own process (``cuda.CSRC`` pointed at an edited copy of
the decode sources), since two builds of one kernel do not share a
process; the builds run in parallel first. ``--baseline DIR`` also times
the decodes as built from another ``csrc/`` directory with the same C
interface (another version of the port), as the row ``baseline``, in the
same call. Writes ``--out`` and prints the share of each kernel's time that
each skip removes.
"""

from __future__ import annotations

import argparse
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

# the decode sources a variant needs (the rest of csrc/ is not built)
SOURCES = ("ray_decode.cu", "ief_decode.cu")

# (file, anchor, replacement) edits of each version; IDT_SKIP's bits as in
# its VARIANTS
EDITS = {
    "wmma": [
        ("decode_common.cuh",
         "                         float* C, int ldc) {\n"
         "  using namespace nvcuda;\n  constexpr int kRowTiles = 4;",
         "                         float* C, int ldc) {\n"
         "  if (IDT_SKIP & 1) return;\n"
         "  using namespace nvcuda;\n  constexpr int kRowTiles = 4;"),
        ("decode_common.cuh",
         "          b, B + (size_t)k * ldb + (grp * kColTiles + c) * 16, ldb);",
         "          b, B + (size_t)((IDT_SKIP & 32) ? 0 : k) * ldb"
         " + (grp * kColTiles + c) * 16, ldb);"),
        ("decode_common.cuh",
         "    wmma::store_matrix_sync(C + rt * 16 * ldc",
         "    if (!(IDT_SKIP & 2)) wmma::store_matrix_sync(C + rt * 16 * ldc"),
        ("decode_common.cuh",
         "  for (int i = threadIdx.x; i < M * kG2; i += blockDim.x)\n    H2[i]",
         "  if (!(IDT_SKIP & 2))\n"
         "  for (int i = threadIdx.x; i < M * kG2; i += blockDim.x)\n    H2[i]"),
        ("decode_common.cuh",
         "  for (int i = threadIdx.x; i < M * kG3; i += blockDim.x)\n    H3[i]",
         "  if (!(IDT_SKIP & 2))\n"
         "  for (int i = threadIdx.x; i < M * kG3; i += blockDim.x)\n    H3[i]"),
        ("decode_common.cuh",
         "    for (int i = threadIdx.x; i < M * kG1; i += blockDim.x) {\n"
         "      const int c = i % kG1;\n      H[i]",
         "    if (!(IDT_SKIP & 2))\n"
         "    for (int i = threadIdx.x; i < M * kG1; i += blockDim.x) {\n"
         "      const int c = i % kG1;\n      H[i]"),
        ("ray_decode.cu",
         "  for (int i = threadIdx.x; i < M * kG1; i += blockDim.x) {\n"
         "    const int row = i / kG1, c = i % kG1;\n    E1[i] = E1[i]",
         "  if (!(IDT_SKIP & 2))\n"
         "  for (int i = threadIdx.x; i < M * kG1; i += blockDim.x) {\n"
         "    const int row = i / kG1, c = i % kG1;\n    E1[i] = E1[i]"),
        ("ray_decode.cu",
         "  for (int i = threadIdx.x; i < M * kG1; i += blockDim.x) {\n"
         "    const int row = i / kG1, c = i % kG1;\n    const float z = C[i]",
         "  if (!(IDT_SKIP & 2))\n"
         "  for (int i = threadIdx.x; i < M * kG1; i += blockDim.x) {\n"
         "    const int row = i / kG1, c = i % kG1;\n    const float z = C[i]"),
        ("ief_decode.cu",
         "  for (int i = threadIdx.x; i < M * kG1; i += blockDim.x)\n"
         "    E1[i] += __ldg(p.b1 + i % kG1);",
         "  if (!(IDT_SKIP & 2))\n"
         "  for (int i = threadIdx.x; i < M * kG1; i += blockDim.x)\n"
         "    E1[i] += __ldg(p.b1 + i % kG1);"),
        ("ray_decode.cu", "  fma_tile<T, MR>(RF, crp",
         "  if (!(IDT_SKIP & 4)) fma_tile<T, MR>(RF, crp"),
        ("ray_decode.cu",
         "  for (int i = threadIdx.x; i < MR * crp; i += blockDim.x) {",
         "  if (!(IDT_SKIP & 8))\n"
         "  for (int i = threadIdx.x; i < MR * crp; i += blockDim.x) {"),
        ("ray_decode.cu",
         "  for (int i = threadIdx.x; i < M * kp; i += blockDim.x) {",
         "  if (!(IDT_SKIP & 8))\n"
         "  for (int i = threadIdx.x; i < M * kp; i += blockDim.x) {"),
        ("ief_decode.cu",
         "  for (int i = threadIdx.x; i < M * kp; i += blockDim.x) {",
         "  if (!(IDT_SKIP & 8))\n"
         "  for (int i = threadIdx.x; i < M * kp; i += blockDim.x) {"),
    ],
    "staged": [
        ("decode_tile.cuh",
         "  const bf16* a0 = A + (wm * MT * 16",
         "  if (IDT_SKIP & 1) return;\n  const bf16* a0 = A + (wm * MT * 16"),
        ("decode_tile.cuh",
         "      cp_async16(dst, src, true);",
         "      if (!(IDT_SKIP & 2)) cp_async16(dst, src, true);"),
        ("decode_tile.cuh",
         "__device__ __forceinline__ void for_pairs(float (&acc)[MT][NT][4], F&& f) {",
         "__device__ __forceinline__ void for_pairs(float (&acc)[MT][NT][4], F&& f) {\n"
         "  if (IDT_SKIP & 4) return;"),
        ("decode_tile.cuh",
         "        if ((lane & 3) == 0) L4[",
         "        if ((lane & 3) == 0 && !(IDT_SKIP & 4)) L4["),
        ("decode_tile.cuh",
         "                                           int col0) {\n"
         "  const int total = valid * c, chunks = total / 8;",
         "                                           int col0) {\n"
         "  if (IDT_SKIP & 8) return;\n"
         "  const int total = valid * c, chunks = total / 8;"),
        ("decode_tile.cuh",
         "  const int per = c / 8;\n  for (int i = threadIdx.x; i < rows * per;",
         "  if (IDT_SKIP & 8) return;\n"
         "  const int per = c / 8;\n  for (int i = threadIdx.x; i < rows * per;"),
        ("ray_decode.cu",
         "    for (int row = warp; row < kM; row += kWarps) {",
         "    if (!(IDT_SKIP & 8))\n"
         "    for (int row = warp; row < kM; row += kWarps) {"),
    ],
}
VARIANTS = {
    "wmma": {"as is": 0, "products": 1, "weights from L2": 32,
            "C round trips": 2, "per-ray FMA": 4, "input staging": 8,
            "all": 15},
    "staged": {"as is": 0, "products": 1, "weight slabs": 2, "epilogues": 4,
            "input staging": 8, "all": 15},
}


def version(csrc: Path) -> str:
    return "staged" if (csrc / "decode_tile.cuh").exists() else "wmma"


def variant_dir(src: Path, out: Path, ver: str, bits: int) -> Path:
    """A copy of the decode sources of ``src`` edited for IDT_SKIP=bits."""
    d = out / f"{ver}_v{bits}" / "csrc"
    if d.exists():
        shutil.rmtree(d)
    d.mkdir(parents=True)
    for p in src.glob("*.cuh"):
        shutil.copy(p, d / p.name)
    for name in SOURCES:
        shutil.copy(src / name, d / name)
    for fname, old, new in EDITS[ver] if bits else ():
        text = (d / fname).read_text()
        if text.count(old) != 1:
            raise ValueError(f"{fname}: anchor not found once: {old!r}")
        (d / fname).write_text(text.replace(old, new))
    for p in d.iterdir():
        p.write_text(f"#ifndef IDT_SKIP\n#define IDT_SKIP {bits}\n#endif\n"
                     + p.read_text())
    return d


def build(dirs):
    """Every variant's libraries, all nvcc runs at once, where a child's
    ``cuda.build_all`` will look for them."""
    nvcc = cuda._nvcc()
    procs = []
    for d in dirs:
        cuda.CSRC = d
        out = d.parent / "build" / cuda._source_hash()
        out.mkdir(parents=True, exist_ok=True)
        for src in sorted(d.glob("*.cu")):
            lib = out / f"lib{src.stem}.so"
            if not lib.exists():
                procs.append((src, lib, subprocess.Popen(
                    [nvcc, *cuda.NVCC_FLAGS, "-I", str(d), "-o", str(lib),
                     str(src)], stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True)))
    logs = []
    for src, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {src}:\n{log}")
        logs.append(f"== {src.parent.parent.name}/{src.name}\n{log}")
    return "\n".join(logs)


def child(csrc: Path, inputs: Path):
    """Time K1, K2 and K4 as built from ``csrc`` on the saved inputs; print
    JSON."""
    cuda.CSRC = csrc
    cuda.BUILD_ROOT = csrc.parent / "build"
    rec = torch.load(inputs, weights_only=False)
    out = {}
    with torch.no_grad():
        for name, fn, warm, reps in (("K1", rd.ray_decode, 2, 10),
                                     ("K2", rd.ray_decode_save, 1, 5),
                                     ("K4", rd.ief_decode, 2, 10)):
            a, kw = rec[name]
            out[name] = cs.time_ms(lambda: fn(*a, **kw), warmup=warm,
                                   reps=reps)
    print(json.dumps(out), flush=True)


def record(dev, path: Path):
    """K1's and K4's inputs from a served frame (their largest calls), K2's
    from a train step."""
    from implicit_depth_torch.builder import build_lidf, build_static
    from implicit_depth_torch.builder import randomize_weights_
    from implicit_depth_torch.config import load_config
    from implicit_depth_torch.infer import DepthCompleter
    from implicit_depth_torch.train.state import TrainState
    from implicit_depth_torch.train.steps import make_lidf_train_step

    cfg = load_config(overrides=cs.SERVE_OVERRIDES)
    lidf, refine = cs.build_models(cfg)
    dc = DepthCompleter(cfg, lidf=lidf, refine=refine, device=dev)
    frame = cs.make_frames(1, cs.FRAME_HW)[0]
    calls = cs.record_calls(cs.kernel_modules(), lambda: dc.complete(*frame))
    rec = {}
    for (name, shape), call in calls.items():
        key = {"ray_decode": "K1", "ief_decode": "K4"}.get(name)
        if key and (key not in rec or shape[0][0] > rec[key][0]):
            rec[key] = (shape[0][0], call)
    rec = {k: v[1] for k, v in rec.items()}
    del dc, lidf, refine
    cfg = load_config(overrides=cs.TRAIN_OVERRIDES)
    gen = torch.Generator().manual_seed(cs.SEED + 1)
    model = randomize_weights_(build_lidf(cfg, build_static(cfg), gen),
                               gen).to(dev)
    state = TrainState.create(model, cfg.training, steps_per_epoch=1000)
    step = make_lidf_train_step(cfg, model, dev)
    batch = cs.train_batches(1, cfg, cs.TRAIN_BATCH, dev)[0]
    train = cs.record_train_calls(step, state, batch,
                                  torch.Generator(device=dev).manual_seed(0))
    rec["K2"] = train["ray_decode_save"]
    torch.save(rec, path)
    return {k: [list(t.shape) for t in a[:2]] for k, (a, _) in rec.items()}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "k1_k4.json")
    ap.add_argument("--variants", default="",
                    help="comma-separated labels to time besides 'as is' "
                         "(default: every variant of the version)")
    ap.add_argument("--baseline", type=Path,
                    help="another csrc/ directory to time as 'baseline'")
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--inputs", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("attribute_k1_k4: no CUDA device")
    if args.child is not None:
        return child(args.child, args.inputs)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    cs.log(smi)
    work = ROOT / "build" / "k1_k4"
    work.mkdir(parents=True, exist_ok=True)
    src = cuda.CSRC
    ver = version(src)
    variants = VARIANTS[ver]
    labels = ["as is", *(v for v in (args.variants.split(",")
                                     if args.variants else variants)
                         if v in variants and v != "as is")]
    builds = [(label, variant_dir(src, work, ver, variants[label]))
              for label in labels]
    if args.baseline is not None:
        builds.append(("baseline", variant_dir(
            args.baseline, work / "baseline", version(args.baseline), 0)))
    log = build([d for _, d in builds])
    for line in log.splitlines():
        if line.startswith("==") or "Compiling" in line or \
                "registers" in line or "spill" in line:
            cs.log("  nvcc:", line.strip())
    cuda.CSRC = src
    inputs = work / "inputs.pt"
    shapes = record(torch.device("cuda"), inputs)
    cs.log(f"inputs (cells or rows, ...): {shapes}")
    rows = {}
    for label, d in builds:
        res = subprocess.run([sys.executable, __file__, "--child", str(d),
                              "--inputs", str(inputs)], capture_output=True,
                             text=True)
        if res.returncode != 0:
            raise RuntimeError(f"{label}: {res.stdout}\n{res.stderr}")
        rows[label] = json.loads(res.stdout.strip().splitlines()[-1])
        cs.log(f"{label}: " + ", ".join(f"{k} {v:.4f} ms"
                                        for k, v in rows[label].items()))
    for k in ("K1", "K2", "K4"):
        base = rows["as is"][k]
        cs.log(f"{k} ({base:.4f} ms): share each skip removes: " + ", ".join(
            f"{label} {(base - v[k]) / base:.1%}" for label, v in rows.items()
            if label not in ("as is", "baseline")))
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"device": smi, "version": ver,
                                    "shapes": shapes, "rows": rows,
                                    "nvcc": log}, indent=1))
    cs.log(f"wrote {args.out}")


if __name__ == "__main__":
    main()
