"""How far f32 summation order alone moves a short stage-1 training run,
beside how far two data-parallel ranks move it from one process, on one
NVIDIA GPU.

    python3 scripts/dp_noise_floor.py [--out build/dp_noise_floor.json]

The run is ``chip_smoke.py``'s phase 23 (``configs/train_lidf.yaml`` at
full width through the CLI, synthetic data, f32, global batch 4, one
epoch of 2 Adam steps from the unit-scale checkpoint), with the ResNet at
one block a stage (``chip_smoke.DP_STAGE1_DEPTH``, as phase 23 runs it)
and at full depth. For each depth it trains
- one process with cuDNN's deterministic algorithms and one with
  PyTorch's own convolutions (cuDNN off): the same algebra summed in
  other orders;
- 2 gloo ranks on the card (2 samples each), with cuDNN's deterministic
  algorithms and with cuDNN off;
and reports, for one process against itself and for 2 ranks against one
process (each with the same convolutions), how many parameter and
BatchNorm tensors lie past ``chip_smoke.assert_params_close``'s bounds
and the worst tensor's outlier count over its limit. ~3 min on an H100.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import tempfile

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def past_bounds(got, want, frac=0.995, atol_bulk=5e-4, atol_max=5e-3):
    """(tensors past the bounds, worst outliers / limit, its name): the
    bounds of ``chip_smoke.assert_params_close``."""
    worst, past = (0.0, ""), 0
    for k, w in want.items():
        d = (got[k].double() - w.double()).abs()
        bad = int((d > atol_bulk + w.double().abs() * 5e-3).sum())
        limit = max(3, int((1 - frac) * d.numel()))
        past += int(bad > limit or d.max().item() >= atol_max)
        worst = max(worst, (bad / limit, k))
    return past, worst[0], worst[1]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(ROOT / "build" /
                                         "dp_noise_floor.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("dp_noise_floor: needs an NVIDIA GPU")
    cs.log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip())
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cudnn_launcher = cs.RANK_LAUNCHER
    native_launcher = cudnn_launcher.replace(
        "torch.backends.cudnn.deterministic = True",
        "torch.backends.cudnn.enabled = False")
    report = {}
    with tempfile.TemporaryDirectory() as d, cs.cudnn_flags(
            deterministic=True, benchmark=False):
        d = pathlib.Path(d)
        for depth, cut in (("one block a stage", cs.DP_STAGE1_DEPTH),
                           ("full depth", [])):
            tag = "cut" if cut else "full"
            sets = [*cs.DP_SET, *cut]
            init = cs.unit_scale_checkpoint("lidf", sets, d / f"init_{tag}")
            sets.append(f"checkpoint_path={init}")
            states = {}
            for conv, launcher, flags in (
                    ("cudnn", cudnn_launcher, {}),
                    ("native", native_launcher, {"enabled": False})):
                cs.RANK_LAUNCHER = launcher
                with cs.cudnn_flags(**flags):
                    one = cs.cli(dev, "lidf", d / f"one_{tag}_{conv}", *sets)
                states["one", conv] = cs.saved_state(
                    pathlib.Path(one.workdir))
                run_dir, _ = cs.finish_ranks(cs.start_ranks(
                    d / f"two_{tag}_{conv}", "lidf", sets))
                states["two", conv] = cs.saved_state(run_dir)
            cs.RANK_LAUNCHER = cudnn_launcher
            rows = {
                "one process, cuDNN against native": past_bounds(
                    states["one", "cudnn"], states["one", "native"]),
                "2 ranks against one process, cuDNN": past_bounds(
                    states["two", "cudnn"], states["one", "cudnn"]),
                "2 ranks against one process, native": past_bounds(
                    states["two", "native"], states["one", "native"])}
            for what, (past, worst, name) in rows.items():
                cs.log(f"{depth}: {what}: {past} of "
                       f"{len(states['one', 'cudnn'])} tensors past the "
                       f"bounds; the worst, {name}, at {worst:.3f} of its "
                       f"outlier limit")
            report[depth] = {k: {"tensors_past": v[0], "worst_share": v[1],
                                 "worst": v[2]} for k, v in rows.items()}
    pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"device": torch.cuda.get_device_name(0),
                   "report": report}, f, indent=1)


if __name__ == "__main__":
    main()
