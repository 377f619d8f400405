"""The round-5 procedural quality benchmark through the port (the recipe of
``scripts/run_disk_r5.sh``, with ``python -m implicit_depth_torch.main``):
the pinned dataset written by ``tools/make_disk_datasets.py`` (seed 0,
560 / 56 / 56 frames at 480x640), stage 1 from ``configs/train_lidf.yaml``,
the two stage-2 variants behind its ``best_network``
(``train_refine_hardneg.yaml``, ``train_refine.yaml``), and the test CSVs
of ``test_lidf.yaml`` and ``test_refine.yaml`` (syn / real x known / novel),
then ``scripts/summarize_quality.py`` against
``docs/quality_targets_r5.json``.

  python -m implicit_depth_torch.tools.quality_r5 --data build/r5_data \\
      --logs build/r5_logs --lidf_epochs 60 --refine_epochs 30

At the recipe's 60 / 30 epochs the tool exits with the gate's code; other
``--lidf_epochs`` / ``--refine_epochs`` cut the run, whose table is a
trend, not the gate (exit 0 once every run finished). An existing
``--data`` is used as it is. ``--copy_to`` gathers the CSVs, epoch logs,
the summary and the timings (no checkpoints) into a small directory.
``--only stage1`` runs only the named runs of ``commands()`` (the dataset
still where ``--data`` does not exist), with no summary: a stage-1 curve
to hold against JAX's epoch log (``tools/compare_epoch_logs.py``).
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import shutil
import subprocess
import sys
import time

ROOT = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))
# the recipe's training settings (scripts/run_disk_r5.sh TRAIN_SET), its
# epochs (stage 1, each stage-2 variant) and its dataset's frames
TRAIN_SET = ["training.batch_size=4", "training.valid_batch_size=2",
             "training.num_workers=8", "training.worker_type=process",
             "training.ckpt_every_steps=500", "training.valid_interval=3"]
RECIPE_EPOCHS = (60, 30)
FRAMES = {"n_train": 560, "n_val": 56, "n_test": 56}


def run(cmd, log_path, timings, name):
    t0 = time.perf_counter()
    with open(log_path, "w") as f:
        # IDT_TIMING: the trainers log each epoch's feed_wait
        proc = subprocess.run(cmd, cwd=ROOT, stdout=f,
                              stderr=subprocess.STDOUT,
                              env={**os.environ, "IDT_TIMING": "1"})
    timings[name] = round(time.perf_counter() - t0, 1)
    print(f"== {name}: exit {proc.returncode} in {timings[name]} s "
          f"(log {log_path})", flush=True)
    if proc.returncode:
        with open(log_path) as f:
            print(f.read()[-4000:], flush=True)
        raise SystemExit(f"{name} failed")


def commands(args, py=sys.executable):
    """The recipe's runs in order, [(name, command)]: the dataset and its
    manifest where ``args.data`` does not exist, stage 1, both stage-2
    variants, the three test runs."""
    out = []
    if not osp.isdir(args.data):
        out += [("dataset", [py, "-m",
                             "implicit_depth_torch.tools.make_disk_datasets",
                             "--out", args.data, "--seed", "0",
                             *(f"--{k}={n}" for k, n in FRAMES.items())]),
                ("manifest", [py, osp.join(ROOT, "scripts",
                                           "dataset_manifest.py"),
                              args.data])]
    data = [f"dataset.cleargrasp_root_dir={args.data}/cleargrasp",
            f"dataset.omniverse_root_dir={args.data}/omniverse"]
    L = args.logs

    def cli(config, log_name, *sets):
        return [py, "-m", "implicit_depth_torch.main", "--device",
                args.device, "--cfg_paths", osp.join(ROOT, "configs", config),
                "--set", f"base_log_dir={L}", f"log_name={log_name}", *data,
                *sets, *args.set]

    lidf = osp.join(L, "lidf", "ckpt")
    out.append(("stage1", cli("train_lidf.yaml", "lidf",
                              "resume=latest_network",
                              f"training.nepochs={args.lidf_epochs}",
                              *TRAIN_SET)))
    frozen = [f"lidf_ckpt_path={lidf}", "lidf_ckpt_name=best_network"]
    for name, config in (("refine_hardneg", "train_refine_hardneg.yaml"),
                         ("refine_plain", "train_refine.yaml")):
        out.append((name, cli(config, name, "resume=latest_network",
                              f"training.nepochs={args.refine_epochs}",
                              *frozen, *TRAIN_SET)))
    out.append(("test_lidf_only", cli("test_lidf.yaml", "test_lidf_only",
                                      f"checkpoint_path={lidf}",
                                      "checkpoint_name=best_network")))
    for v in ("refine_hardneg", "refine_plain"):
        out.append((f"test_{v}", cli(
            "test_refine.yaml", f"test_{v}",
            f"checkpoint_path={osp.join(L, v, 'ckpt')}",
            "checkpoint_name=best_network", *frozen)))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--data", default="datasets_disk_r5")
    ap.add_argument("--logs", default="logs/disk_run_r5_port")
    ap.add_argument("--lidf_epochs", type=int, default=RECIPE_EPOCHS[0])
    ap.add_argument("--refine_epochs", type=int, default=RECIPE_EPOCHS[1])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--copy_to", default=None)
    ap.add_argument("--only", nargs="*", default=None,
                    help="run only these runs of commands(), no summary")
    ap.add_argument("--set", nargs="*", default=[],
                    help="more dotted overrides for every run")
    args = ap.parse_args(argv)

    py, timings = sys.executable, {}
    args.data, args.logs = osp.abspath(args.data), osp.abspath(args.logs)
    os.makedirs(args.logs, exist_ok=True)
    L = args.logs
    for name, cmd in commands(args, py):
        if args.only is None or name in args.only + ["dataset", "manifest"]:
            run(cmd, osp.join(L, f"{name}.log"), timings, name)
    if args.only is not None:
        copy_results(args, L)
        print(f"== quality_r5 done: {timings} (only {args.only})", flush=True)
        return 0
    summary = subprocess.run(
        [py, osp.join(ROOT, "scripts", "summarize_quality.py"), L,
         "--gate", osp.join(ROOT, "docs", "quality_targets_r5.json")],
        cwd=ROOT, capture_output=True, text=True)
    cut = (args.lidf_epochs, args.refine_epochs) != RECIPE_EPOCHS
    verdict = (f"cut to {args.lidf_epochs} / {args.refine_epochs} epochs of "
               f"the recipe's {RECIPE_EPOCHS[0]} / {RECIPE_EPOCHS[1]}: a "
               "trend, not the gate" if cut else "the gate")
    print(summary.stdout + summary.stderr, flush=True)
    with open(osp.join(L, "summary.txt"), "w") as f:
        f.write(summary.stdout + summary.stderr
                + f"\ngate exit {summary.returncode} ({verdict})\n")
    with open(osp.join(L, "timings.json"), "w") as f:
        json.dump({"seconds": timings, "lidf_epochs": args.lidf_epochs,
                   "refine_epochs": args.refine_epochs}, f)
    copy_results(args, L)
    print(f"== quality_r5 done: {timings}; gate exit {summary.returncode} "
          f"({verdict})", flush=True)
    return 0 if cut else summary.returncode


def copy_results(args, L):
    if args.copy_to:
        for d, _, files in os.walk(L):
            for fn in files:
                if fn.endswith((".csv", ".jsonl", ".txt", ".json", ".log",
                                ".yaml")):
                    src = osp.join(d, fn)
                    dst = osp.join(args.copy_to, osp.relpath(src, L))
                    os.makedirs(osp.dirname(dst), exist_ok=True)
                    shutil.copy(src, dst)
        manifest = osp.join(args.data, "MANIFEST.sha256")
        if osp.exists(manifest):
            shutil.copy(manifest, args.copy_to)


if __name__ == "__main__":
    sys.exit(main())
