"""CLI launcher (counterpart of ``implicit_depth_tpu/main.py``).

Parity: src/main.py:11-51 — two flags (default config + overlay configs),
seeding, dynamic trainer dispatch — plus ``--set`` dotted overrides,
``--device`` (default ``cuda``; the trainers raise without a card unless
``cpu`` is asked for) and ``--dist_backend``. One process drives one
device; launched by ``torchrun`` (or with its ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` set by hand) each
process is a rank of a parallel run (``parallel/mesh.py``) on
``cuda:LOCAL_RANK``, and ``training.batch_size`` is the global batch: the
ranks take JAX's ``("data", "rays")`` layout, so that with fewer images
than ranks the ranks of an image split its rays (4 ranks at batch 2: data
2 × rays 2).

Usage:
  python -m implicit_depth_torch.main --cfg_paths configs/train_lidf.yaml
  python -m implicit_depth_torch.main --cfg_paths configs/test_refine.yaml
  python -m implicit_depth_torch.main --device cpu \\
      --cfg_paths configs/smoke_synthetic.yaml --set training.nepochs=1
  torchrun --nproc_per_node 4 -m implicit_depth_torch.main \\
      --cfg_paths configs/train_lidf.yaml          # NCCL, one card a rank
  torchrun --nproc_per_node 2 -m implicit_depth_torch.main --device cuda:0 \\
      --dist_backend gloo --cfg_paths ...          # two ranks on one card
  torchrun --nproc_per_node 4 -m implicit_depth_torch.main \\
      --cfg_paths configs/train_lidf.yaml \\
      --set training.batch_size=2                  # data 2 x rays 2
"""

from __future__ import annotations

import argparse
import ast

import numpy as np

from implicit_depth_torch.parallel import mesh


def parse_overrides(pairs) -> dict:
    """``["a.b=1", "c=x"]`` -> ``{"a": {"b": 1}, "c": "x"}``: each value
    read by ``ast.literal_eval``, else kept as a string."""
    overrides = {}
    for kv in pairs:
        key, _, value = kv.partition("=")
        node = overrides
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        try:
            node[parts[-1]] = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            node[parts[-1]] = value
    return overrides


def make_trainer(argv=None):
    """The configured trainer, built (and resumed or loaded, as its config
    says) but not run."""
    parser = argparse.ArgumentParser("implicit_depth_torch")
    parser.add_argument("--default_cfg_path", default=None,
                        help="optional base YAML applied before cfg_paths")
    parser.add_argument("--cfg_paths", nargs="+", default=[],
                        help="experiment YAML overlays, applied in order")
    parser.add_argument("--set", nargs="*", default=[],
                        help="dotted overrides, e.g. training.lr=1e-4")
    parser.add_argument("--device", default=None,
                        help="torch device to run on (default cuda, under "
                        "torchrun cuda:LOCAL_RANK; or cpu)")
    parser.add_argument("--dist_backend", default=None,
                        choices=mesh.BACKENDS,
                        help="process group backend under torchrun (default "
                        "nccl on a card, gloo on the cpu; gloo shares a "
                        "card between ranks)")
    args = parser.parse_args(argv)
    device = mesh.init_from_env(args.device, args.dist_backend)

    from implicit_depth_torch.config import load_config

    paths = ([args.default_cfg_path] if args.default_cfg_path else []) + args.cfg_paths
    cfg = load_config(*paths, overrides=parse_overrides(args.set))

    if cfg.seed is not None:
        np.random.seed(cfg.seed)

    from implicit_depth_torch.train.trainer import TRAINERS

    return TRAINERS[cfg.trainer_name](cfg, device=device)


def main(argv=None):
    """Runs the configured trainer (train, or valid / test) and returns it.
    A process group it joined is left at the end, an exception included,
    so that no rank stays waiting on this one (after an exception at once,
    without the barrier of a clean exit)."""
    clean = False
    try:
        trainer = make_trainer(argv)
        exp_type = trainer.cfg.exp_type
        if exp_type == "train":
            trainer.run()
        elif exp_type in ("valid", "test"):
            trainer.test()
        else:
            raise ValueError(f"unknown exp_type {exp_type!r}")
        clean = True
        return trainer
    finally:
        mesh.shutdown(clean)


if __name__ == "__main__":
    main()
