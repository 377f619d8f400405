"""Masked row-wise reductions over the static (R, K) pair slots
(counterpart of ``implicit_depth_tpu/ops/masked.py``): the reference's ragged
per-ray scatter_softmax / scatter_max become row ops with -1e30 / -inf
padding."""

from __future__ import annotations

import torch

_NEG = -1e30


def masked_softmax(logits: torch.Tensor, mask: torch.Tensor, dim: int = -1):
    """Softmax with False entries excluded. All-False rows return zeros."""
    z = torch.where(mask, logits, torch.full_like(logits, _NEG))
    z = z - z.amax(dim=dim, keepdim=True)
    e = torch.where(mask, torch.exp(z), torch.zeros_like(z))
    return e / e.sum(dim=dim, keepdim=True).clamp(min=1e-30)


def masked_log_softmax(logits: torch.Tensor, mask: torch.Tensor,
                       dim: int = -1):
    """Log-softmax over the True entries; False entries return -1e30."""
    z = torch.where(mask, logits, torch.full_like(logits, _NEG))
    m = z.amax(dim=dim, keepdim=True)
    e = torch.where(mask, torch.exp(z - m), torch.zeros_like(z))
    lse = m + torch.log(e.sum(dim=dim, keepdim=True).clamp(min=1e-30))
    return torch.where(mask, logits - lse, torch.full_like(logits, _NEG))


def masked_argmax(values: torch.Tensor, mask: torch.Tensor, dim: int = -1):
    """Argmax over True entries, ties to the first. Returns (idx, any_valid);
    idx is 0 for all-False rows."""
    z = torch.where(mask, values, torch.full_like(values, float("-inf")))
    idx = z.argmax(dim=dim)
    any_valid = mask.any(dim=dim)
    return torch.where(any_valid, idx, torch.zeros_like(idx)), any_valid


def take_slot(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """values[..., idx] along the last (slot) dimension."""
    return values.gather(-1, idx[..., None].long())[..., 0]
