"""Readings from which a cell's limits are set, in one process on the
card: the program's compared numbers over many seeds (the lower
readings), the control's (the plain reference computed with fp8 operands
in the program's place) and each planted fault's (the upper readings)::

    python3 benchmark/calibrate.py --workload train.lidf.b32 \
        --seeds 11 12 13 --control-seeds 11 12 13 --faults frozen half_batch

One JSON line a reading: {"seed", "what" ("program", "control" or the
fault), "readings"}; "witness_bf16" puts the reference with bf16
operands in the program's place; the window of each run is ``--seconds`` long.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark.harness import faults, spec  # noqa: E402


# the reference put in the program's place: the control (fp8 operands)
# and a witness of bfloat16 rounding (bf16 operands)
AGAINST = {"control": "fp8", "witness_bf16": "bf16"}


def one(cell, seed, seconds, what, device, out):
    t0 = time.perf_counter()
    drv = spec.driver(cell).Driver(cell, seed, torch.device(device))
    if what not in ("program", *AGAINST):
        faults.plant(drv, what)
    drv.setup()
    drv.window(seconds)
    drv.release()
    r = drv.readings(against=AGAINST[what]) if what in AGAINST \
        else drv.readings()
    line = {"workload": cell.name, "seed": seed, "what": what, "readings": r,
            "seconds": time.perf_counter() - t0}
    print(json.dumps(line), flush=True)
    if out:
        with open(out, "a") as f:
            f.write(json.dumps(line) + "\n")
    del drv
    if device == "cuda":
        torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--witness-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    cell = spec.load_cell(a.workload)
    for s in a.seeds:
        one(cell, s, a.seconds, "program", a.device, a.out)
    for s in a.control_seeds:
        one(cell, s, a.seconds, "control", a.device, a.out)
    for s in a.witness_seeds:
        one(cell, s, a.seconds, "witness_bf16", a.device, a.out)
    for f in a.faults:
        for s in a.fault_seeds or a.control_seeds:
            one(cell, s, a.seconds, f, a.device, a.out)


if __name__ == "__main__":
    main()
