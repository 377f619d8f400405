"""NeRF-style positional encoding (counterpart of
``implicit_depth_tpu/models/embedder.py``): the input, then per frequency
2^0..2^(m-1) a sin block and a cos block; multires=8 -> 3 + 3·2·8 = 51 dims,
multires_views=4 -> 27. cos x is computed as sin(x + π/2) with π/2 rounded
to f32, exactly as the JAX package does."""

from __future__ import annotations

import math

import torch

from implicit_depth_torch.utils import profiling


def posenc_dim(multires: int, input_dims: int = 3, enabled: bool = True) -> int:
    if not enabled or multires <= 0:
        return input_dims
    return input_dims * (1 + 2 * multires)


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
