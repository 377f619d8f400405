"""Static-shape valid-point sampler (counterpart of
``implicit_depth_tpu/geometry/sampling.py::sample_valid_stratified``).

Exactly ``n`` valid pixels per image, stratified over the valid set in 8×8
pixel block-scan order, resampling with repetition when fewer exist
(≙ the reference's ``point_utils.sample_valid_points``). The jitter inside
each stride comes from an explicit ``torch.Generator``; it cannot reproduce
``jax.random``'s draw, so callers that need the JAX draw pass the indices in
(``prepare_inputs(valid_idx=...)``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=8)
def _block_order_perm(h: int, w: int, block_y: int, block_x: int) -> np.ndarray:
    """perm[k] = flat image index of the k-th pixel in block-scan order."""
    ids = np.arange(h * w).reshape(h // block_y, block_y, w // block_x, block_x)
    return ids.transpose(0, 2, 1, 3).reshape(-1)


def sample_valid_stratified(valid_mask: torch.Tensor, n_sample: int,
                            generator: torch.Generator | None = None,
                            block_y: int = 8, block_x: int = 8):
    """valid_mask (B, H, W) bool -> (idx (B, n) int32 flat indices,
    slot (B, n) bool — all False for an image with no valid pixel,
    cnt (B,) int32 valid-pixel counts)."""
    b, h, w = valid_mask.shape
    dev = valid_mask.device
    m = h * w
    perm = torch.from_numpy(_block_order_perm(h, w, block_y, block_x)).to(dev)
    mask_block = valid_mask.reshape(b, m)[:, perm]
    # order[j] = block position of the j-th valid pixel (cumsum rank + scatter)
    rank = torch.cumsum(mask_block.long(), dim=1) - 1
    rank = torch.where(mask_block, rank, torch.full_like(rank, m))
    order = torch.zeros((b, m + 1), dtype=torch.long, device=dev)
    order.scatter_(1, rank, torch.arange(m, device=dev).expand(b, m))
    cnt = mask_block.sum(dim=1)
    cnt_safe = cnt.clamp(min=1)

    i = torch.arange(n_sample, device=dev)
    stride = (cnt_safe // n_sample).clamp(min=1)
    gen_dev = generator.device if generator is not None else dev
    u = torch.rand((b, n_sample), generator=generator, device=gen_dev).to(dev)
    jitter = torch.minimum((u * stride[:, None]).long(), stride[:, None] - 1)
    rank_many = torch.minimum((i * cnt_safe[:, None]) // n_sample + jitter,
                              cnt_safe[:, None] - 1)
    rank_few = i % cnt_safe[:, None]
    r = torch.where((cnt >= n_sample)[:, None], rank_many, rank_few)
    idx = perm[order.gather(1, r)]
    slot = (cnt > 0)[:, None].expand(b, n_sample)
    return idx.to(torch.int32), slot, cnt.to(torch.int32)
