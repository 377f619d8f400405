"""Static-shape point/ray samplers (counterpart of
``implicit_depth_tpu/geometry/sampling.py``).

* :func:`sample_valid_stratified` — exactly ``n`` valid pixels per image,
  stratified over the valid set in 8×8 pixel block-scan order, resampling
  with repetition when fewer exist (≙ the reference's
  ``point_utils.sample_valid_points``).
* :func:`sample_masked_window` — the training miss rays: a random contiguous
  window of ``n`` entries of each image's mask pixels (raster order), or all
  of them, with the remaining slots marked invalid.

The random draws come from an explicit ``torch.Generator``; they cannot
reproduce ``jax.random``'s, so callers that need the JAX draw pass it in
(``prepare_inputs(valid_idx=..., miss_start=...)``). A rank of a
data-parallel run passes ``shard=(rank, world)``: :func:`draw_uniform`
then draws the global batch's tensor and keeps the rank's rows, so that
the ranks see a 1-process run's draws and their generators stay equal.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from implicit_depth_torch.utils import profiling


@functools.lru_cache(maxsize=8)
def _block_order_perm(h: int, w: int, block_y: int, block_x: int) -> np.ndarray:
    """perm[k] = flat image index of the k-th pixel in block-scan order."""
    ids = np.arange(h * w).reshape(h // block_y, block_y, w // block_x, block_x)
    return ids.transpose(0, 2, 1, 3).reshape(-1)


def draw_uniform(shape, generator: torch.Generator | None, device,
                 shard=(0, 1)) -> torch.Tensor:
    """U[0, 1) of ``shape`` (leading axis the batch) on ``device``, drawn
    from ``generator`` on its own device. ``shard`` (r, n): rows
    [r·b, (r+1)·b) of a draw of the global batch's n·b rows."""
    r, n = shard
    b = shape[0]
    gen_dev = generator.device if generator is not None else device
    u = torch.rand((n * b, *shape[1:]), generator=generator, device=gen_dev)
    return u[r * b:(r + 1) * b].to(device)


def _nonzero_first_order(mask_flat: torch.Tensor,
                         rank: torch.Tensor | None = None) -> torch.Tensor:
    """(B, M) bool -> (B, M) int64: order[b, j] = index of the j-th True
    entry of row b; entries past the True count are 0 (callers mask them).
    A cumsum rank and one scatter, no sort; ``rank`` is ``cumsum - 1`` when
    the caller has it."""
    b, m = mask_flat.shape
    if rank is None:
        rank = torch.cumsum(mask_flat.long(), dim=1) - 1
    rank = torch.where(mask_flat, rank.long(), torch.full_like(rank, m, dtype=torch.long))
    order = torch.zeros((b, m + 1), dtype=torch.long, device=mask_flat.device)
    order.scatter_(1, rank, torch.arange(m, device=mask_flat.device).expand(b, m))
    return order[:, :m]


def sample_masked_window(mask_flat: torch.Tensor, n_sample: int,
                         generator: torch.Generator | None = None,
                         rank: torch.Tensor | None = None,
                         start: torch.Tensor | None = None, shard=(0, 1)):
    """Sample <= ``n_sample`` indices per image from a (B, M) bool mask.

    ``rank``: ``cumsum(mask_flat, 1) - 1`` when the caller has it; ``start``
    (B,) replaces the random window start (drawn from ``generator``, at
    ``shard``: :func:`draw_uniform`).

    Returns idx (B, n) int32 flat indices (0 where the slot is invalid),
    slot (B, n) bool, cnt (B,) int32 mask pixels, start (B,) int32: slot j
    holds the (start + j)-th True entry in index order."""
    b, m = mask_flat.shape
    if n_sample > m:
        raise ValueError(f"n_sample {n_sample} exceeds the {m} pixels")
    dev = mask_flat.device
    order = _nonzero_first_order(mask_flat, rank)
    cnt = mask_flat.sum(dim=1)
    if start is None:
        max_start = (cnt - n_sample).clamp(min=0)
        u = draw_uniform((b,), generator, dev, shard)
        start = torch.minimum((u * (max_start + 1)).long(), max_start)
    start = start.to(device=dev, dtype=torch.long)
    j = start[:, None] + torch.arange(n_sample, device=dev)
    idx = order.gather(1, j)
    slot = j < cnt[:, None]
    return (idx.to(torch.int32), slot, cnt.to(torch.int32),
            start.to(torch.int32))


def sample_valid_stratified(valid_mask: torch.Tensor, n_sample: int,
                            generator: torch.Generator | None = None,
                            block_y: int = 8, block_x: int = 8,
                            shard=(0, 1)):
    """valid_mask (B, H, W) bool -> (idx (B, n) int32 flat indices,
    slot (B, n) bool — all False for an image with no valid pixel,
    cnt (B,) int32 valid-pixel counts). The jitter is drawn from
    ``generator`` at ``shard`` (:func:`draw_uniform`)."""
    b, h, w = valid_mask.shape
    dev = valid_mask.device
    m = h * w
    with profiling.span("sync.block_order"):  # a copy from pageable memory
        perm = torch.from_numpy(_block_order_perm(h, w, block_y,
                                                  block_x)).to(dev)
    mask_block = valid_mask.reshape(b, m)[:, perm]
    order = _nonzero_first_order(mask_block)  # block positions
    cnt = mask_block.sum(dim=1)
    cnt_safe = cnt.clamp(min=1)

    i = torch.arange(n_sample, device=dev)
    stride = (cnt_safe // n_sample).clamp(min=1)
    u = draw_uniform((b, n_sample), generator, dev, shard)
    jitter = torch.minimum((u * stride[:, None]).long(), stride[:, None] - 1)
    rank_many = torch.minimum((i * cnt_safe[:, None]) // n_sample + jitter,
                              cnt_safe[:, None] - 1)
    rank_few = i % cnt_safe[:, None]
    r = torch.where((cnt >= n_sample)[:, None], rank_many, rank_few)
    idx = perm[order.gather(1, r)]
    slot = (cnt > 0)[:, None].expand(b, n_sample)
    return idx.to(torch.int32), slot, cnt.to(torch.int32)
