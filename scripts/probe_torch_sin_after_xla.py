#!/usr/bin/env python
"""How often the first CPU ``torch.sin`` of a process that has already run an
XLA computation differs from the next, identical call.

Each trial is a fresh process (2 torch threads) that runs one jitted JAX
computation, then ``torch.sin`` twice on the same (512, 96) f32 arguments
of the size the positional encodings reach (~100), and reports whether the
two results differ. With ``--warm`` the process calls ``torch.sin`` once
before the JAX computation. The port's CPU parity tests
(``tests/test_torch_port_*.py``) make that warm-up call.

    JAX_PLATFORMS=cpu python scripts/probe_torch_sin_after_xla.py \\
        --trials 240 --parallel 8 [--warm]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor


def trial(warm: bool) -> str:
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    torch.set_num_threads(2)
    xn = (76.8 * np.random.default_rng(1).normal(size=(512, 96))).astype(np.float32)
    x = torch.from_numpy(xn)
    if warm:
        torch.sin(x)
    np.asarray(jax.jit(lambda v: jnp.sin(v) @ jnp.ones((96, 64)))(xn))
    d = (torch.sin(x) - torch.sin(x)).abs()
    rows = (d.amax(1) > 0).nonzero().reshape(-1)
    if not rows.numel():
        return "same"
    return (f"differs: max {d.max().item():.3g}, rows "
            f"{rows.min().item()}..{rows.max().item()}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=240)
    ap.add_argument("--parallel", type=int, default=8)
    ap.add_argument("--warm", action="store_true")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(trial(args.warm))
        return
    cmd = [sys.executable, os.path.abspath(__file__), "--one"] + \
        (["--warm"] if args.warm else [])
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}

    def run(_):
        out = subprocess.run(cmd, capture_output=True, text=True, env=env)
        return out.stdout.strip().splitlines()[-1] if out.returncode == 0 \
            else f"error: {out.stderr.strip().splitlines()[-1]}"

    with ThreadPoolExecutor(args.parallel) as pool:
        results = list(pool.map(run, range(args.trials)))
    differ = [r for r in results if r.startswith("differs")]
    errors = [r for r in results if r.startswith("error")]
    print(f"warm={args.warm}: {len(differ)} of {len(results)} processes "
          f"differ, {len(errors)} errors")
    for r in sorted(set(differ + errors)):
        print(" ", r)


if __name__ == "__main__":
    main()
