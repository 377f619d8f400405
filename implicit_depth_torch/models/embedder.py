"""NeRF-style positional encoding (counterpart of
``implicit_depth_tpu/models/embedder.py``): the input, then per frequency
2^0..2^(m-1) a sin block and a cos block; multires=8 -> 3 + 3·2·8 = 51 dims,
multires_views=4 -> 27. cos x is computed as sin(x + π/2) with π/2 rounded
to f32, exactly as the JAX package does. The encoding's width
(``posenc_dim``) is the decode kernels' operand format's, from
``ops/decode_common.py``."""

from __future__ import annotations

import math

import torch

from implicit_depth_torch.ops.decode_common import posenc_dim  # noqa: F401
from implicit_depth_torch.utils import profiling


def positional_encoding(x: torch.Tensor, multires: int,
                        enabled: bool = True) -> torch.Tensor:
    """x (..., D) -> (..., D·(1 + 2·multires)); identity when disabled."""
    if not enabled or multires <= 0:
        return x
    xf = x.float()
    with profiling.span("sync.posenc_consts"):  # copies from pageable memory
        freqs = torch.tensor([2.0 ** j for j in range(multires)],
                             dtype=torch.float32, device=x.device)
        phase = torch.tensor([0.0, math.pi / 2], dtype=torch.float32,
                             device=x.device)
    # (..., m, 2, D): x·2^j (exact) + phase, columns ordered (j, sin|cos, d)
    arg = (xf[..., None, None, :] * freqs[:, None, None]) + phase[:, None]
    trig = torch.sin(arg).reshape(*x.shape[:-1], -1)
    return torch.cat([x, trig.to(x.dtype)], dim=-1)
