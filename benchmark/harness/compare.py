"""The comparisons that decide ``correct``: each reading beside its limit
(from the cell's workload file), and the numerics the reference runs in."""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List

import numpy as np
import torch


@contextlib.contextmanager
def reference_numerics():
    """float32 products without TF32 for the reference, the program's
    settings restored after it."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def judge(readings: Dict[str, float], limits: Dict[str, float]) -> Dict:
    """{name: {value, limit, ok}} of each number that ``limits`` compares:
    it passes at or below its limit; a number missing, or not a number,
    fails, and so does a cell with no limit at all."""
    if not limits:
        return {"limits_set": {"value": 0.0, "limit": 1.0, "ok": False}}
    out = {}
    for k, lim in limits.items():
        v = float(readings.get(k, float("nan")))
        out[k] = {"value": v, "limit": lim,
                  "ok": math.isfinite(v) and v <= lim}
    return out


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              leaves: List[str]) -> List[float]:
    """Each leaf's gap between two norms, |a - b|, over the larger of the
    reference's norm of that leaf and of the median leaf."""
    med = float(np.median([ref[k] for k in leaves]))
    return [abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in leaves]
