"""Implicit decoders: IMNet and IEF (counterpart of
``implicit_depth_tpu/models/imnet.py``).

4-layer MLP (inp -> 4g -> 2g -> g -> out, g = imnet_gf) with LeakyReLU(0.02);
the last layer's kernel starts at mean 1e-5; outputs are soft-clamped to
~(0, 1) by max(min(x, 0.01x + 0.99), 0.01x) unless sigmoid. IEF starts from
offset 0.001, encodes the running offset (1 -> 16, appended at the END of
layer 1's input) and makes ``n_iter`` additive passes through the MLP.

These modules hold the decoder parameters and compute the plain forward;
the serving path decodes through ``ops/ray_decode.py`` (kernels K1, K4),
which take the same parameters split by embedding part.
"""

from __future__ import annotations

import torch
from torch import nn

from implicit_depth_torch.models.init import dense, linear

LEAKY = 0.02


def soft_clamp01(x: torch.Tensor) -> torch.Tensor:
    """max(min(x, 0.01x + 0.99), 0.01x) — near-identity in (0,1)."""
    return torch.maximum(torch.minimum(x, 0.01 * x + 0.99), 0.01 * x)


def _act(v: torch.Tensor) -> torch.Tensor:
    return nn.functional.leaky_relu(v, LEAKY)


class MLP4(nn.Module):
    """The ``_MLP4`` of the JAX package: layers l0..l3."""

    def __init__(self, in_dim: int, gf_dim: int, out_dim: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.l0 = dense(in_dim, gf_dim * 4, generator, std=0.02)
        self.l1 = dense(gf_dim * 4, gf_dim * 2, generator, std=0.02)
        self.l2 = dense(gf_dim * 2, gf_dim, generator, std=0.02)
        self.l3 = dense(gf_dim, out_dim, generator, std=0.02, mean=1e-5)

    def layers(self):
        return self.l0, self.l1, self.l2, self.l3

    def forward(self, x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
        h = _act(linear(x, self.l0, dtype))
        h = _act(linear(h, self.l1, dtype))
        h = _act(linear(h, self.l2, dtype))
        return linear(h, self.l3, dtype)


class IMNet(nn.Module):
    def __init__(self, in_dim: int, out_dim: int = 1, gf_dim: int = 64,
                 use_sigmoid: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.use_sigmoid = use_sigmoid
        self.mlp = MLP4(in_dim, gf_dim, out_dim, generator)

    def forward(self, x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
        y = self.mlp(x, dtype).float()
        return torch.sigmoid(y) if self.use_sigmoid else soft_clamp01(y)


class IEF(nn.Module):
    def __init__(self, in_dim: int, out_dim: int = 1, gf_dim: int = 64,
                 n_iter: int = 2, use_sigmoid: bool = False,
                 init_offset: float = 0.001,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.out_dim, self.n_iter = out_dim, n_iter
        self.use_sigmoid, self.init_offset = use_sigmoid, init_offset
        self.offset_enc = dense(1, 16, generator, std=0.02)
        self.mlp = MLP4(in_dim + 16, gf_dim, out_dim, generator)

    def forward(self, x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
        offset = torch.full((*x.shape[:-1], self.out_dim), self.init_offset,
                            dtype=torch.float32, device=x.device)
        for _ in range(self.n_iter):
            feat = linear(offset, self.offset_enc, dtype)
            offset = offset + self.mlp(torch.cat([x.to(dtype), feat], -1),
                                       dtype).float()
        return torch.sigmoid(offset) if self.use_sigmoid else soft_clamp01(offset)

    def decode_weights(self, detach: bool = True) -> dict:
        """The decode weight dict of ``ops/ray_decode.split_ief_weights``,
        JAX (in, out) layout: enc_w/enc_b and w1..w4/b1..b4; detached for
        the forward-only kernel, else views of the live parameters (the
        training decode)."""
        w = {"enc_w": self.offset_enc.weight.t(), "enc_b": self.offset_enc.bias}
        for i, lin in enumerate(self.mlp.layers(), 1):
            w[f"w{i}"], w[f"b{i}"] = lin.weight.t(), lin.bias
        return {k: v.detach() for k, v in w.items()} if detach else w
