"""Convert a reference checkpoint (``best_network.pth``) into a port
checkpoint directory (the counterpart of ``scripts/import_torch_ckpt.py``;
a file conversion on the host)::

  python -m implicit_depth_torch.tools.import_torch_ckpt \\
      --pth /path/to/best_network.pth --out logs/imported_lidf/ckpt

The directory then loads as ``--set checkpoint_path=<out>`` (or, for a
stage-1 file behind stage 2, ``lidf_ckpt_path=<out>``), through
``DepthCompleter.from_checkpoint`` and ``tools/complete_depth.py
--lidf_ckpt <out>``. The stage is read from the file's keys (a stage-2
file holds ``pnet_model_refine``) unless ``--stage`` names it; a stage-2
file's ROI width is ``--rgb_out`` (32, the default model's).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--pth", required=True, help="reference .pth checkpoint")
    ap.add_argument("--out", required=True, help="output checkpoint dir")
    ap.add_argument("--stage", default="auto",
                    choices=["auto", "lidf", "refine"])
    ap.add_argument("--rgb_out", type=int, default=32,
                    help="ResNet feature width of a stage-2 file's model")
    args = ap.parse_args(argv)

    from implicit_depth_torch.utils.torch_import import import_torch_checkpoint
    stage = import_torch_checkpoint(args.pth, args.out, args.stage,
                                    rgb_out=args.rgb_out)
    print(f"imported {stage} checkpoint from {args.pth} -> {args.out}")


if __name__ == "__main__":
    sys.exit(main())
