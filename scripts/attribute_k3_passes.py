"""Split the device time of K3's Pass A (``csrc/ray_decode_bwd.cu``) among
its costs, on one NVIDIA GPU.

    python3 scripts/attribute_k3_passes.py [--out build/k3_passes.json]
        [--variants "as is,products"] [--baseline DIR]

Records the inputs of K3 from one stage-1 train step (batch 4, 240x320,
bf16, ``chip_smoke``'s helpers), then times K3 on them, every instance
(from K2's saves; recomputing layer 1; from K2 'all''s full saves, made by
K2 'all' from the same inputs), as built and in measurement builds with one
cost of Pass A skipped each (outputs wrong, time only):

* ``stream writes``: Pass A's writes of the weight gradients' operands;
* ``products``: every product of Pass A (tails, input gradients, d_rows,
  d_ray_feat, the recompute's layer 1);
* ``serial``: the column sums, the layer-4 weight gradient and the IEF
  offset sums between ``__syncthreads``;
* ``table sums``: the pre-reduction of the rows that share a cell and its
  adds into the block's copy of d_vox_table;
* ``staging X``: the [vox | pos6 | trig] tile;
* ``saved loads``: the loads of K2's e1 and z1p (the saves' instance);
* all six at once: what is left (the elementwise passes and the
  ``__syncthreads`` between them).

Each build is its own process (``cuda.CSRC`` pointed at an edited copy of
the sources), since two builds of one kernel do not share a process; each
reports Pass A and Pass B from the CUDA events K3's C function records
between its launches. Writes ``--out`` and prints the share of Pass A each
skip removes. ``--baseline DIR`` also times K3 as another version builds
and calls it, on the same inputs, as the row ``baseline``: ``DIR`` is the
root of that version's tree (e.g. a ``git archive`` unpacked under
``build/``), whose own copy of this script runs in a process of its own
with that tree's package and sources (its K3 instances only).
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

# (anchor, replacement) edits of ray_decode_bwd.cu; IDT_SKIP's bits as in
# VARIANTS
EDITS = [
    ("  const int per_row = width * (int)sizeof(T) / 16;",
     "  if (IDT_SKIP & 1) return;\n"
     "  const int per_row = width * (int)sizeof(T) / 16;"),
    ("T* stage = nullptr) {",
     "T* stage = nullptr) {\n  if (IDT_SKIP & 2) return;"),
    ("const float* X, int ldx, int M, int N, float* g) {",
     "const float* X, int ldx, int M, int N, float* g) {\n"
     "  if (IDT_SKIP & 4) return;"),
    ("  for (int c = threadIdx.x; c <= kG3; c += blockDim.x) {",
     "  if (!(IDT_SKIP & 4)) for (int c = threadIdx.x; c <= kG3; "
     "c += blockDim.x) {"),
    ("    if (off_i != nullptr) {",
     "    if (off_i != nullptr && !(IDT_SKIP & 4)) {"),
    # the links are then left unset, so the walk over them goes too
    ("      if (!LEAD[r]) continue;",
     "      if (!LEAD[r] || (IDT_SKIP & 8)) continue;"),
    ("      int lead = 1, next = -1;",
     "      if (IDT_SKIP & 8) break;\n      int lead = 1, next = -1;"),
    ("    auto stage_x = [&]() {",
     "    auto stage_x = [&]() {\n      if (IDT_SKIP & 16) return;"),
    ("            load8(p.e1 + grow(r) * kG1 + c, e);",
     "            if (!(IDT_SKIP & 32)) load8(p.e1 + grow(r) * kG1 + c, e);"),
    ("        if (row_ok(r)) load8(p.z1p + grow(r) * kG1 + i % kG1, z);",
     "        if (row_ok(r) && !(IDT_SKIP & 32))\n"
     "          load8(p.z1p + grow(r) * kG1 + i % kG1, z);"),
]
VARIANTS = {"as is": 0, "stream writes": 1, "products": 2, "serial": 4,
            "table sums": 8, "staging X": 16, "saved loads": 32,
            "all six": 63}


def variant_dir(out: Path, bits: int) -> Path:
    """A copy of csrc/ with ray_decode_bwd.cu edited for IDT_SKIP=bits."""
    d = out / f"v{bits}" / "csrc"
    if d.exists():
        shutil.rmtree(d)
    shutil.copytree(cuda.CSRC, d)
    src = (d / "ray_decode_bwd.cu").read_text()
    for old, new in EDITS:
        if src.count(old) != 1:
            raise ValueError(f"anchor not found once: {old!r}")
        src = src.replace(old, new)
    (d / "ray_decode_bwd.cu").write_text(
        f"#define IDT_SKIP {bits}\n" + src)
    return d


def child(csrc: Path, inputs: Path):
    """Time K3 as built from ``csrc`` on the saved inputs; print JSON."""
    cuda.CSRC = csrc
    cuda.BUILD_ROOT = csrc.parent / "build"
    (vt, cells, pos, rf, w, saved, g_off, g_logit), kw = torch.load(
        inputs, weights_only=False)
    out = {}
    with torch.no_grad():
        full = rd.ray_decode_save_all(vt, cells, pos, rf, w, **kw)[2]
        for inst, sv in (("kernel_save", saved), ("kernel", None),
                         ("kernel_save_all", full)):
            args = (vt, cells, pos, rf, w, sv, g_off, g_logit)
            ms = cs.time_ms(lambda: rd.ray_decode_bwd(*args, **kw),
                            warmup=1, reps=5)
            runs = [rd.ray_decode_bwd_pass_ms(*args, **kw)
                    for _ in range(3)]
            out[inst] = {"ms": ms, **{k: sorted(r[k] for r in runs)[1]
                                      for k in ("pass_a_ms", "pass_b_ms",
                                                "reduce_ms")}}
    print(json.dumps(out), flush=True)


def record(dev, path: Path):
    from implicit_depth_torch.builder import (
        build_lidf,
        build_static,
        randomize_weights_,
    )
    from implicit_depth_torch.config import load_config
    from implicit_depth_torch.train.state import TrainState
    from implicit_depth_torch.train.steps import make_lidf_train_step

    cfg = load_config(overrides=cs.TRAIN_OVERRIDES)
    gen = torch.Generator().manual_seed(cs.SEED + 1)
    model = randomize_weights_(build_lidf(cfg, build_static(cfg), gen),
                               gen).to(dev)
    state = TrainState.create(model, cfg.training, steps_per_epoch=1000)
    step = make_lidf_train_step(cfg, model, dev)
    batch = cs.train_batches(1, cfg, cs.TRAIN_BATCH, dev)[0]
    rec = cs.record_train_calls(step, state, batch,
                                torch.Generator(device=dev).manual_seed(0))
    torch.save(rec["ray_decode_bwd"], path)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "k3_passes.json")
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated labels of VARIANTS to time")
    ap.add_argument("--baseline", type=Path,
                    help="another csrc/ directory to time as 'baseline'")
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--inputs", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("attribute_k3_passes: no CUDA device")
    if args.child is not None:
        return child(args.child, args.inputs)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    cs.log(smi)
    work = ROOT / "build" / "k3_passes"
    work.mkdir(parents=True, exist_ok=True)
    inputs = work / "inputs.pt"
    record(torch.device("cuda"), inputs)
    rows = {}
    labels = ["as is", *(v for v in args.variants.split(",")
                         if v in VARIANTS and v != "as is")]
    builds = [(label, variant_dir(work, VARIANTS[label])) for label in labels]
    script = {label: Path(__file__) for label, _ in builds}
    if args.baseline is not None:
        root = args.baseline.resolve()
        builds.append(("baseline", root / "implicit_depth_torch" / "csrc"))
        script["baseline"] = root / "scripts" / "attribute_k3_passes.py"
    for label, d in builds:
        res = subprocess.run([sys.executable, str(script[label]), "--child",
                              str(d), "--inputs", str(inputs)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"{label}: {res.stdout}\n{res.stderr}")
        rows[label] = json.loads(res.stdout.strip().splitlines()[-1])
        cs.log(f"{label}: {rows[label]}")
    for inst in rows["as is"]:
        if "baseline" in rows and inst in rows["baseline"]:
            b, a = rows["baseline"][inst], rows["as is"][inst]
            cs.log(f"K3 {inst}: ms {a['ms']:.3f} (baseline {b['ms']:.3f}, "
                   f"{a['ms'] - b['ms']:+.3f}); reduce_ms "
                   f"{a['reduce_ms']:.3f} ({b['reduce_ms']:.3f})")
        base = rows["as is"][inst]["pass_a_ms"]
        cs.log(f"K3 {inst}: share of Pass A ({base:.3f} ms) each skip "
               "removes: " + ", ".join(
                   f"{k} {(base - v[inst]['pass_a_ms']) / base:.1%}"
                   for k, v in rows.items()
                   if k not in ("as is", "baseline")))
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"device": smi, "rows": rows}, indent=1))
    cs.log(f"wrote {args.out}")


if __name__ == "__main__":
    main()
