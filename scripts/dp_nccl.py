"""``chip_smoke.py``'s phases 23-24 under NCCL, one card a rank, on a
machine with several NVIDIA GPUs (the branch ``chip_smoke.py`` takes when
it sees two or more cards).

    python3 scripts/dp_nccl.py [--worlds 2 4]

For each world size N (at most the cards seen): stage 1
(``configs/train_lidf.yaml``, full width, one ResNet block a stage, f32,
global batch 4, one epoch of 2 steps from a unit-scale checkpoint) on N
NCCL ranks against one process on the same global batch, with
``chip_smoke.dp_phase``'s checks (losses, parameters within
``assert_params_close``'s bounds, launches per rank per step, only rank 0
writing); at N = 2 also a second run of the ranks, bit for bit the first,
and stage 2 (``configs/train_refine_hardneg.yaml``) behind a unit-scale
stage 1. Raises at the first check that fails. ~1.5 min on 4 H100s.
"""

from __future__ import annotations

import argparse
import os
import pathlib
import sys
import tempfile

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--worlds", type=int, nargs="+", default=[2, 4])
    args = ap.parse_args()
    cards = torch.cuda.device_count()
    if cards < 2:
        sys.exit(f"dp_nccl: needs 2 or more cards, sees {cards}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    os.environ["IDT_TIMING"] = "1"
    dev = torch.device("cuda")
    cs.log(f"{cards} x {torch.cuda.get_device_name(0)}")
    with tempfile.TemporaryDirectory() as d, cs.cudnn_flags(
            deterministic=True, benchmark=False):
        d = pathlib.Path(d)
        sets1 = [*cs.DP_SET, *cs.DP_STAGE1_DEPTH]
        init1 = cs.unit_scale_checkpoint("lidf", sets1, d / "init1")
        stage1 = cs.unit_scale_checkpoint("lidf", cs.DP_SET, d / "stage1")
        runs = [(world, "lidf", [*sets1, f"checkpoint_path={init1}"],
                 cs.EXPECT_PER_STEP, world == 2)
                for world in args.worlds if world <= cards]
        if 2 in args.worlds:
            runs.append((2, "refine_hardneg",
                         [*cs.DP_SET, f"lidf_ckpt_path={stage1}"],
                         cs.EXPECT_PER_REFINE_STEP, False))
        for world, stage, sets, per_step, repeat in runs:
            w = d / f"{stage}_{world}"
            group = cs.dp_start(w, stage, sets, world=world, backend="nccl",
                                device=None, repeat=repeat)
            try:
                cs.dp_phase(dev, w, stage, sets, per_step,
                            f"NCCL {stage} on {world} cards", group)
            finally:
                cs.stop_ranks(group)
    cs.log("dp_nccl: every check passed")


if __name__ == "__main__":
    main()
