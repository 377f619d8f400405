"""Hard-negative mining over the global batch (counterpart of
``implicit_depth_tpu/parallel/hardneg.py``).

The JAX step takes the top-k of the logically global array (GSPMD
partitions it); its shard_map form takes each shard's local candidates,
gathers them and takes the global top-k. :func:`sharded_hard_neg_mean` is
that two-stage reduction for a rank of a process group, returning the
rank's share of the global mean, so that its gradient reaches only the
rank's own elements and the ranks' gradients sum to the 1-process one.
"""

from __future__ import annotations

from typing import Optional

import torch

from implicit_depth_torch.parallel import mesh


def sharded_hard_neg_mean(x_local: torch.Tensor, mask_local: torch.Tensor,
                          ratio: float,
                          split: Optional[mesh.Split] = None) -> torch.Tensor:
    """This rank's share of the mean of the top ``ratio`` fraction of the
    masked values of the global (B, R) array: the sum of its own elements
    among the global top-k over the count of finite values in that top-k,
    ``k = max(int(B·R · ratio), 1)``. ``x_local`` (b, r) is the block of
    the global array that ``split`` places (default: the train step's
    split under the layout, :func:`mesh.train_split`); with ragged ray
    blocks the ranks' blocks differ in size.

    Each rank takes its top ``min(k, b·r)`` candidates, padded with -inf
    to a common length; the candidates are gathered (detached), and their
    top-k gives the k-th value ``t``. Exactly k elements are taken, as one
    ``torch.topk`` over the global array takes them: every element above
    ``t`` and as many at ``t`` as fill k. The sum is the same whichever
    tied elements fill it; they are taken in global index order (row by
    row of the global array, within a row block by block: each rank's
    count of ties in each of its rows is gathered with the row's place),
    which is the order ``jax.lax.top_k`` takes them in (``torch.topk``
    leaves the order of ties unspecified), so the gradient at a tie
    follows JAX's."""
    b = x_local.shape[0]
    flat2 = torch.where(mask_local, x_local,
                        torch.full((), float("-inf"), dtype=x_local.dtype,
                                   device=x_local.device)).reshape(b, -1)
    split = split or mesh.train_split(flat2.shape[1])
    flat = flat2.reshape(-1)
    n_local = flat.shape[0]
    k = max(int(b * split.rows * split.n * ratio), 1)
    widest = max(e - s for s, e in (
        mesh.ray_block(split.n, split.blocks, i) for i in range(split.blocks)))
    width = min(k, b * widest)
    cand = torch.topk(flat.detach(), min(k, n_local)).values
    if cand.shape[0] < width:
        cand = torch.cat([cand, cand.new_full((width - cand.shape[0],),
                                              float("-inf"))])
    every = mesh.all_gather(cand)                          # (world, width)
    top = torch.topk(every.reshape(-1), k).values
    t = top[-1]
    # each row's place in the global order, its elements above t and at t
    det = flat2.detach()
    at_t = det == t
    key = ((split.row * b + torch.arange(b, device=det.device)) * split.blocks
           + split.block)
    stats = mesh.all_gather(torch.stack(
        [key, (det > t).sum(1), at_t.sum(1)], 1)).reshape(-1, 3)
    need = k - stats[:, 1].sum()
    order = torch.argsort(stats[:, 0])
    ties = stats[order, 2]
    before = torch.empty_like(ties).scatter_(0, order,
                                             torch.cumsum(ties, 0) - ties)
    mine = before[mesh.rank() * b:(mesh.rank() + 1) * b]
    take = (need - mine).clamp(min=0)
    sel = (det > t) | (at_t & (torch.cumsum(at_t, 1) <= take[:, None]))
    sel = sel & torch.isfinite(det)
    count = torch.isfinite(top).sum().clamp(min=1)
    return (torch.where(sel, flat2, torch.zeros_like(flat2)).sum()
            / count.to(flat2.dtype))
