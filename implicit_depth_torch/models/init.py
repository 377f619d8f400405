"""Parameter initialisers drawing from an explicit ``torch.Generator``,
following the JAX package's flax initialisers."""

from __future__ import annotations

import math

import torch
from torch import nn


@torch.no_grad()
def normal_(t: torch.Tensor, std: float, generator: torch.Generator | None,
            mean: float = 0.0) -> None:
    t.copy_(torch.randn(t.shape, generator=generator) * std + mean)


def dense(in_dim: int, out_dim: int, generator: torch.Generator | None,
          std: float | None = None, mean: float = 0.0) -> nn.Linear:
    """nn.Linear with kernel ~ N(mean, std) (default: lecun normal,
    std = 1/sqrt(fan_in), flax's Dense default) and a zero bias."""
    lin = nn.Linear(in_dim, out_dim)
    normal_(lin.weight, std if std is not None else 1.0 / math.sqrt(in_dim),
            generator, mean)
    nn.init.zeros_(lin.bias)
    return lin


class PreparedWeights:
    """Weight operands derived from some modules' parameters, prepared once
    and reused while those parameters stay as they are.

    ``get`` prepares again when a parameter was written in place (its
    version counter moved), was given new storage (a move to another
    device, a new tensor), or ``extra`` (e.g. the compute dtype) changed."""

    def __init__(self):
        self._key = None
        self._pinned = None
        self._value = None

    def get(self, modules, extra, prepare):
        params = [p for m in modules for p in m.parameters()]
        key = (extra, tuple((p.data_ptr(), p.device, p._version)
                            for p in params))
        if key != self._key:
            self._value, self._key = prepare(), key
            # hold the keyed storages, so that no new tensor can reuse
            # their addresses while the key names them
            self._pinned = [p.data for p in params]
        return self._value


def linear(x: torch.Tensor, lin: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """A Dense layer computed in ``dtype`` as flax's ``nn.Dense(dtype=...)``
    does: the product of the cast operands is rounded to ``dtype``, then the
    cast bias is added."""
    return x.to(dtype) @ lin.weight.to(dtype).t() + lin.bias.to(dtype)
