"""Time K6 (the `global` / dense stage-1 pair decode, ``csrc/pair_decode.cu``)
on the inputs of served frames, beside another version of the port, on one
NVIDIA GPU.

    python3 scripts/attribute_k6.py [--baseline DIR] [--rounds 1]
        [--frames] [--out build/k6.json]

Records K6's bf16 calls from one 480x640 frame in the ``global`` mode
(budget 8) and one in the dense mode with ``chip_smoke``'s helpers, and
saves their operands (voxel table, cells, positions, ray features, ray ids)
with the decoder weights in the models' layout, the call's options and the
``global`` frame's row count. Each version then times them in a process of
its own, which imports that version's package and builds its kernels there
(``DIR`` is the root of another checkout of the port, e.g. ``git archive
14a3f96`` unpacked under ``build/``; it prepares the weights with its own
``prep_pair_decode_weights``, so the C interfaces may differ): ``global``
over every row, ``global`` with the row count (where the version takes
one), and dense; median of CUDA-event times (the version's own
``chip_smoke.time_ms``: 10 after 2 warm-ups). With ``--frames`` each
version also serves, in each mode, a warm-up frame and then the next frame
of ``chip_smoke``'s seeded 480x640 frames under torch.profiler, and
reports that frame's device time (the sum of every device operation's own
time, as ``chip_smoke.profile_device_ms``), with its own ``chip_smoke``'s
models and frames (the same seed in both versions). The versions run in
turns, baseline first: baseline, this tree, this tree, baseline,
``--rounds`` times. Writes ``--out`` and prints each version's times.
"""

from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def frame_device_ms(cs):
    """{mode: device ms of one served frame} in the global and dense modes,
    with the models and frames of ``cs`` (a version's chip_smoke)."""
    from torch.profiler import ProfilerActivity, profile
    from implicit_depth_torch.config import load_config
    from implicit_depth_torch.infer import DepthCompleter

    frames = cs.make_frames(2, cs.FRAME_HW)
    out = {}
    for mode in cs.MODES:
        cfg = load_config(overrides=cs.mode_overrides(cs.SERVE_OVERRIDES,
                                                      mode))
        lidf, refine = cs.build_models(cfg)
        dc = DepthCompleter(cfg, lidf=lidf, refine=refine,
                            device=torch.device("cuda"))
        dc.complete(*frames[0])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            dc.complete(*frames[1])
            torch.cuda.synchronize()
        us = sum(ev.self_device_time_total for ev in prof.key_averages()
                 if str(ev.device_type).endswith("CUDA")
                 and not getattr(ev, "is_user_annotation", False))
        out[f"{mode} frame device"] = us / 1e3
        del dc, lidf, refine
        torch.cuda.empty_cache()
    return out


def child(root: Path, inputs: Path, frames: bool):
    """Time the K6 of the package under ``root`` on the saved calls (and,
    with ``frames``, a frame in each mode); print JSON {case: ms}."""
    sys.path.insert(0, str(root))
    import chip_smoke as cs  # the version's own
    from implicit_depth_torch.ops import pair_decode as pd
    rec = torch.load(inputs, weights_only=False)
    takes_count = "n_rows" in inspect.signature(pd.pair_decode).parameters
    out = {}
    with torch.no_grad():
        for mode, c in rec.items():
            w = pd.prep_pair_decode_weights(c["weights"], *c["dims"],
                                            torch.bfloat16)
            vt, cells, pos, rf, rays = c["args"]
            a = (vt, cells, pos, rf, w, rays)
            got = pd.pair_decode(*a, **c["kw"])
            torch.cuda.synchronize()
            if not all(torch.isfinite(g).all() for g in got):
                raise AssertionError(f"{mode}: outputs not finite")
            key = "global all rows" if mode == "global" else mode
            out[key] = cs.time_ms(lambda: pd.pair_decode(*a, **c["kw"]))
            if mode == "global" and takes_count:
                kw = {**c["kw"], "n_rows": c["n_rows"]}
                out["global with the count"] = cs.time_ms(
                    lambda: pd.pair_decode(*a, **kw))
    if frames:
        out.update(frame_device_ms(cs))
    print(json.dumps(out), flush=True)


def record(dev, path: Path) -> dict:
    """K6's operands from one served frame in each mode; returns each mode's
    rows and (global) rows decoded."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from implicit_depth_torch.config import load_config
    from implicit_depth_torch.infer import DepthCompleter
    from implicit_depth_torch.models.lidf import decoder_weights

    frame = cs.make_frames(1, cs.FRAME_HW)[0]
    rec, info = {}, {}
    for mode in cs.MODES:
        cfg = load_config(overrides=cs.mode_overrides(cs.SERVE_OVERRIDES,
                                                      mode))
        lidf, refine = cs.build_models(cfg)
        dc = DepthCompleter(cfg, lidf=lidf, refine=refine, device=dev)
        calls = cs.record_calls(
            {"pair_decode": cs.kernel_modules()["pair_decode"]},
            lambda: dc.complete(*frame))
        (a, kw), = calls.values()
        vt, cells, pos, rf, w, rays = a
        n_rows = kw.pop("n_rows", None)
        rec[mode] = {
            "args": (vt, cells, pos, rf, rays), "kw": kw, "n_rows": n_rows,
            "dims": w["dims"],
            "weights": {k: v.detach() for k, v in
                        decoder_weights(lidf.offset_dec,
                                        lidf.prob_dec).items()}}
        info[mode] = {"rows": cells.shape[0],
                      "rows_decoded": None if n_rows is None
                      else int(n_rows.item())}
        del dc, lidf, refine
        torch.cuda.empty_cache()
    torch.save(rec, path)
    return info


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "k6.json")
    ap.add_argument("--baseline", type=Path,
                    help="the root of another version of the port")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--frames", action="store_true",
                    help="also the device time of a frame in each mode")
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--inputs", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("attribute_k6: no CUDA device")
    if args.child is not None:
        return child(args.child, args.inputs, args.frames)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    work = ROOT / "build" / "k6"
    work.mkdir(parents=True, exist_ok=True)
    inputs = work / "inputs.pt"
    info = record(torch.device("cuda"), inputs)
    print(f"inputs: {info}", flush=True)
    versions = [("this", ROOT)]
    if args.baseline is not None:
        versions = [("baseline", args.baseline.resolve()), *versions]
    order = (versions + versions[::-1]) * args.rounds
    runs = []
    for label, root in order:
        res = subprocess.run([sys.executable, __file__, "--child", str(root),
                              "--inputs", str(inputs),
                              *(["--frames"] if args.frames else [])],
                             capture_output=True, text=True, cwd=root)
        if res.returncode != 0:
            raise RuntimeError(f"{label}: {res.stdout}\n{res.stderr}")
        times = json.loads(res.stdout.strip().splitlines()[-1])
        runs.append({"version": label, **times})
        print(f"{label}: " + ", ".join(f"{k} {v:.4f} ms"
                                       for k, v in times.items()), flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"device": smi, "inputs": info,
                                    "runs": runs}, indent=1))
    print(f"wrote {args.out}", flush=True)


if __name__ == "__main__":
    main()
