"""Hold a stage-1 run's validation curve against a reference run's, epoch
by epoch: two ``epoch_log.jsonl`` files as the trainers write them
(``train/trainer.py``; the JAX trainer writes the same format, e.g.
``docs/results_disk_r5/lidf60_epoch_log.jsonl``).

For every epoch that both runs validated, each split's a1 (delta < 1.05)
and rmse (m) are printed side by side. Then the rule: the run *tracks* the
reference when, on every split and over those common epochs,
  - its lowest rmse is at most ``RMSE_FACTOR`` (1.15) times the
    reference's lowest, and
  - its highest a1 is at least ``A1_FACTOR`` (0.75) times the
    reference's highest.
The two factors were fixed before the port's comparison run (PERF.md §6)
and are not options, so a verdict cannot be re-decided afterwards.
The exit code is 0 when it tracks, 1 when it does not (2: no common
validated epoch).

  python -m implicit_depth_torch.tools.compare_epoch_logs \\
      logs/disk_run_r5_port/lidf/epoch_log.jsonl \\
      docs/results_disk_r5/lidf60_epoch_log.jsonl
"""

from __future__ import annotations

import argparse
import json
import sys

RMSE_FACTOR = 1.15
A1_FACTOR = 0.75


def read_valid(path):
    """{epoch: {split: {"a1": x, "rmse": y}}} of the epochs that validated
    (the last line of an epoch wins, as after a resume)."""
    out = {}
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            rec = json.loads(line)
            if "valid" in rec:
                out[int(rec["epoch"])] = {
                    s: {"a1": float(m["a1"]), "rmse": float(m["rmse"])}
                    for s, m in rec["valid"].items()}
    return out


def compare(run, ref):
    """The side-by-side rows and the rule's checks. ``run`` and ``ref`` are
    ``read_valid``'s dicts. Returns (epochs, splits, checks, tracks):
    ``checks`` one dict a split with both runs' extremes, the limits and
    whether each holds."""
    epochs = sorted(set(run) & set(ref))
    splits = [s for s in ref[epochs[0]] if s in run[epochs[0]]] if epochs \
        else []
    checks = []
    for s in splits:
        run_rmse = min(run[e][s]["rmse"] for e in epochs)
        ref_rmse = min(ref[e][s]["rmse"] for e in epochs)
        run_a1 = max(run[e][s]["a1"] for e in epochs)
        ref_a1 = max(ref[e][s]["a1"] for e in epochs)
        checks.append({
            "split": s, "rmse": run_rmse, "ref_rmse": ref_rmse,
            "rmse_limit": RMSE_FACTOR * ref_rmse,
            "rmse_ok": run_rmse <= RMSE_FACTOR * ref_rmse,
            "a1": run_a1, "ref_a1": ref_a1, "a1_limit": A1_FACTOR * ref_a1,
            "a1_ok": run_a1 >= A1_FACTOR * ref_a1})
    tracks = bool(checks) and all(c["rmse_ok"] and c["a1_ok"]
                                  for c in checks)
    return epochs, splits, checks, tracks


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("run", help="the run's epoch_log.jsonl")
    ap.add_argument("ref", help="the reference's epoch_log.jsonl")
    args = ap.parse_args(argv)

    run, ref = read_valid(args.run), read_valid(args.ref)
    epochs, splits, checks, tracks = compare(run, ref)
    if not epochs:
        print("no epoch validated in both logs")
        return 2
    print("a1 / rmse (m)")
    print("| epoch | " + " | ".join(f"{s} run | {s} reference"
                                    for s in splits) + " |")
    print("|---|" + "---|---|" * len(splits))
    for e in epochs:
        cells = [f"{run[e][s]['a1']:.3f} / {run[e][s]['rmse']:.3f} | "
                 f"{ref[e][s]['a1']:.3f} / {ref[e][s]['rmse']:.3f}"
                 for s in splits]
        print(f"| {e} | " + " | ".join(cells) + " |")
    for c in checks:
        print(f"{c['split']}: lowest rmse {c['rmse']:.4f} against "
              f"{c['rmse_limit']:.4f} ({RMSE_FACTOR} x {c['ref_rmse']:.4f})"
              f" {'ok' if c['rmse_ok'] else 'MISSED'}; highest a1 "
              f"{c['a1']:.4f} against {c['a1_limit']:.4f} ({A1_FACTOR} x "
              f"{c['ref_a1']:.4f}) {'ok' if c['a1_ok'] else 'MISSED'}")
    print(json.dumps({"epochs": epochs, "tracks": tracks, "checks": checks}))
    print("verdict: the run tracks the reference" if tracks else
          "verdict: the run does not track the reference")
    return 0 if tracks else 1


if __name__ == "__main__":
    sys.exit(main())
