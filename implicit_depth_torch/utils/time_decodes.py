"""Time the decode kernels K1, K2 ('l1' and 'all'), K3 (its three
instances), K4 and K6 (``global`` with its row count, and dense) at the
default decoder widths (imnet_gf 64, or each ``--gf``) and the main path's
shapes, beside another version of the port, on one NVIDIA GPU.

    python3 implicit_depth_torch/utils/time_decodes.py [--baseline DIR]
        [--kb 8 [4 12 16 ...]] [--gf 64 [8 16 32 ...]] [--rounds 1]
        [--dtype bfloat16|float32] [--model default|W7]
        [--out build/time_decodes.json]

``--model W7`` sets the layer-1 widths of every width option of the
reference at its extreme at once (pnet_out 512, multires 10, rgb_out 64,
roi_out_bbox 4; imnet_gf is ``--gf``'s, so W2 is the default widths at
``--gf 128``); ``--dtype`` the operands' type (the f32 instances are the
card-vs-CPU cross-checks').

The operands are drawn from a seed with numpy, the same in every version:
K1 and K4 on a served 480x640 frame (76,800 rays of kb pair slots, for
each ``--kb``, default 8; 76,800 refine rows), K2 and K3 on a training step
of batch 4 (80,000 rays of kb pair slots),
K6 on the frame's 614,400 ``global`` rows (budget 8) with 215,040 of them
below the row count, and on its 1,536,000 dense rows (K = 20). Each version
times them in a process of its own, which imports that version's package
from its root (``DIR`` is another checkout's root, e.g. ``git archive
<commit>`` unpacked under ``build/``), builds its kernels there and
prepares the weights with its own functions, so the C interfaces may
differ: the median of 10 CUDA-event times after 2 warm-ups (50 for a
kernel under 2 ms), bf16. A
version whose wrapper refuses a budget (a port from before every budget
was taken) times nothing there: null. K1, K2 and K3 are keyed "<kernel>
kb<kb>". The versions run in turns, baseline first (baseline, this tree,
this tree, baseline), ``--rounds`` times. Writes ``--out`` and prints each
kernel's times and this tree's over the baseline's. At an imnet_gf other
than 64 every key ends in " gf<g>", then " <model>" at other widths than
the default and " f32" in float32. A version that refuses a width times
nothing there: null.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

THIS_ROOT = Path(__file__).resolve().parents[2]
SEED = 0
# the default model's widths
C_VOX, C_ROI, C_DIR, MULTIRES = 128, 128, 27, 8
C_END, C_POS = 128, 51
# (pnet_out, roi features, multires, refine pnet_out) of each width set
MODELS = {"default": (C_VOX, C_ROI, MULTIRES, C_END),
          "W7": (512, 1024, 10, 512)}
SERVE_RAYS, TRAIN_RAYS, CELLS = 76800, 80000, 729
GLOBAL_ROWS, GLOBAL_COUNT, DENSE_SLOTS = 614400, 215040, 20


def _mlp(rng, w, prefix, in_dim, gf4):
    dims = [(in_dim, gf4), (gf4, gf4 // 2), (gf4 // 2, gf4 // 4),
            (gf4 // 4, 1)]
    for i, (a, b) in enumerate(dims, 1):
        w[f"{prefix}w{i}"] = rng.normal(size=(a, b)) / a ** 0.5
        w[f"{prefix}b{i}"] = 0.1 * rng.normal(size=(b,))


def _time(fn, warmup=2, reps=10):
    """The median CUDA-event ms of ``reps`` calls after ``warmup``; 5x the
    calls for one under 2 ms, whose single readings spread by ~15%."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for i in range(reps * 5):
        if i == reps and statistics.median(times) >= 2.0:
            break
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def worker(budgets, gfs, dtype="bfloat16", model="default"):
    """Times every kernel with the package on sys.path, at each imnet_gf of
    ``gfs``, K1-K3 at each of ``budgets``, the widths of ``model`` in
    ``dtype``; prints one JSON line {kernel: ms}."""
    import torch

    from implicit_depth_torch.ops import cuda

    cuda.build_all()
    out = {}
    for g in gfs:
        tag = ("" if g == 64 else f" gf{g}") + (
            "" if model == "default" else f" {model}") + (
            " f32" if dtype == "float32" else "")
        out.update({k + tag: v for k, v in times_at(
            budgets, 4 * g, getattr(torch, dtype), MODELS[model]).items()})
        torch.cuda.empty_cache()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "ms": out}),
          flush=True)


def times_at(budgets, gf4, bf=None, widths=MODELS["default"]):
    """{kernel: ms} of every kernel with decoders 4g = ``gf4`` wide, in the
    type ``bf`` (default bf16), at the layer-1 ``widths`` (MODELS)."""
    import numpy as np
    import torch

    from implicit_depth_torch.ops import ief_decode as ied
    from implicit_depth_torch.ops import pair_decode as pd
    from implicit_depth_torch.ops import ray_decode as rd

    C_VOX, C_ROI, MULTIRES, C_END = widths
    dev, bf = torch.device("cuda"), bf or torch.bfloat16
    rng = np.random.default_rng(SEED)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a)).to(dev, dtype)

    c_embed = C_VOX + C_ROI + 6 * (1 + 2 * MULTIRES) + C_DIR
    w = {"off_enc_w": rng.normal(size=(1, 16)),
         "off_enc_b": 0.1 * rng.normal(size=(16,))}
    _mlp(rng, w, "off_", c_embed + 16, gf4)
    _mlp(rng, w, "prob_", c_embed, gf4)
    w = {k: t(v) for k, v in w.items()}
    k1w = rd.prep_ray_decode_weights(w, C_VOX, C_ROI, C_DIR, MULTIRES, bf)

    def rays(n, images, kb):
        return (t(rng.normal(size=(images * CELLS, C_VOX)), bf),
                t(rng.integers(0, images * CELLS, (n, kb)), torch.int32),
                t(0.6 * rng.normal(size=(n, kb, 6))),
                t(rng.normal(size=(n, C_ROI + C_DIR)), bf))

    def timed(fn, reps=10):  # null where this version refuses the budget
        try:
            return _time(fn, reps=reps)
        except ValueError:
            return None

    out = {}
    for kb in budgets:
        serve = rays(SERVE_RAYS, 1, kb)
        out[f"K1 kb{kb}"] = timed(lambda: rd.ray_decode(*serve, k1w))
        train = rays(TRAIN_RAYS, 4, kb)
        cot = (t(rng.normal(size=(TRAIN_RAYS, kb))),
               t(rng.normal(size=(TRAIN_RAYS, kb))))
        out[f"K2 l1 kb{kb}"] = timed(lambda: rd.ray_decode_save(*train, k1w))
        out[f"K2 all kb{kb}"] = timed(
            lambda: rd.ray_decode_save_all(*train, k1w))
        for name, fwd in (("K3 from l1 saves", rd.ray_decode_save),
                          ("K3 from full saves", rd.ray_decode_save_all),
                          ("K3 recompute", None)):
            try:
                saved = fwd(*train, k1w)[2] if fwd else None
            except ValueError:
                out[f"{name} kb{kb}"] = None
                continue
            out[f"{name} kb{kb}"] = timed(
                lambda: rd.ray_decode_bwd(*train, k1w, saved, *cot), reps=5)
            del saved
        del train, cot
        torch.cuda.empty_cache()
    serve = rays(SERVE_RAYS, 1, 8)
    iw = {"enc_w": rng.normal(size=(1, 16)),
          "enc_b": 0.1 * rng.normal(size=(16,))}
    c_rc = C_ROI + C_DIR
    _mlp(rng, iw, "", C_END + c_rc + C_POS + 16, gf4)
    k4w = ied.prep_ief_weights({k: t(v) for k, v in iw.items()}, C_END, c_rc,
                               C_POS, C_DIR, bf)
    rows = tuple(t(rng.normal(size=(SERVE_RAYS, c)), bf)
                 for c in (C_END, c_rc, C_POS))
    out["K4"] = timed(lambda: ied.ief_decode(*rows, k4w))
    k6w = pd.prep_pair_decode_weights(w, C_VOX, C_ROI, C_DIR, MULTIRES, bf)
    table, ray_feat = serve[0], serve[3]
    for name, p, indexed, count in (
            ("K6 global", GLOBAL_ROWS, True, GLOBAL_COUNT),
            ("K6 dense", SERVE_RAYS * DENSE_SLOTS, False, None)):
        args = (table, t(rng.integers(0, CELLS, p), torch.int32),
                t(0.6 * rng.normal(size=(p, 6))), ray_feat, k6w,
                t(rng.integers(0, SERVE_RAYS, p), torch.int32)
                if indexed else None)
        kw = {} if count is None else {
            "n_rows": torch.tensor(count, dtype=torch.int32, device=dev)}
        out[name] = timed(lambda: pd.pair_decode(*args, **kw))
    return out


def run_version(root: Path, budgets, gfs, dtype="bfloat16",
                model="default") -> dict:
    """One worker process with the package of ``root``."""
    code = ("import sys; sys.path.insert(0, %r); "
            "sys.argv = ['time_decodes', '--worker', '--kb', *%r, '--gf', "
            "*%r, '--dtype', %r, '--model', %r]; __file__ = %r; "
            "exec(open(__file__).read())") % (
                str(root), [str(kb) for kb in budgets],
                [str(g) for g in gfs], dtype, model, __file__)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=root)
    if res.returncode != 0:
        raise RuntimeError(f"{root}: exit {res.returncode}\n"
                           f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", action="store_true",
                    help="time with the package on sys.path (internal)")
    ap.add_argument("--baseline", type=Path, default=None)
    ap.add_argument("--kb", type=int, nargs="+", default=[8],
                    help="pair slots a ray of K1-K3's operands")
    ap.add_argument("--gf", type=int, nargs="+", default=[64],
                    help="imnet_gf of the decoders")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16")
    ap.add_argument("--model", choices=list(MODELS), default="default",
                    help="the layer-1 widths of the widest options")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if args.worker:
        worker(args.kb, args.gf, args.dtype, args.model)
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    versions = {"this": THIS_ROOT}
    if args.baseline:
        versions["baseline"] = args.baseline.resolve()
    order = (["baseline", "this", "this", "baseline"] if args.baseline
             else ["this"]) * args.rounds
    runs = {v: [] for v in versions}
    for v in order:
        got = run_version(versions[v], args.kb, args.gf, args.dtype,
                          args.model)
        runs[v].append(got["ms"])
        print(v, json.dumps(got["ms"]), flush=True)
    summary = {}
    for k in runs["this"][0]:
        row = {v: [r[k] for r in rs] for v, rs in runs.items()}
        if "baseline" in row and None not in row["this"] + row["baseline"]:
            row["this_over_baseline"] = (statistics.mean(row["this"])
                                         / statistics.mean(row["baseline"]))
        summary[k] = row
        print(k, json.dumps(row), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": smi, "runs": runs,
                                        "summary": summary}, indent=1))


if __name__ == "__main__":
    main()
