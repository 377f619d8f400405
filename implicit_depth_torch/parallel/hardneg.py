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

import torch

from implicit_depth_torch.parallel import mesh


def sharded_hard_neg_mean(x_local: torch.Tensor, mask_local: torch.Tensor,
                          ratio: float) -> torch.Tensor:
    """This rank's share of the mean of the top ``ratio`` fraction of the
    masked values of the global array (the ranks' ``x_local`` in rank
    order; every rank's of the same size): the sum of its own elements
    among the global top-k over the count of finite values in that top-k,
    ``k = max(int(n_local · world · ratio), 1)``.

    Each rank takes its top ``min(k, n_local)`` candidates, the candidates
    are gathered (detached), and their top-k gives the k-th value ``t``.
    Exactly k elements are taken, as one ``torch.topk`` over the global
    array takes them: every element above ``t`` and as many at ``t`` as
    fill k. The sum is the same whichever tied elements fill it; they are
    taken in global index order (rank by rank, each in flat order), which
    is the order ``jax.lax.top_k`` takes them in (``torch.topk`` leaves
    the order of ties unspecified), so the gradient at a tie follows
    JAX's."""
    flat = torch.where(mask_local, x_local,
                       torch.full((), float("-inf"), dtype=x_local.dtype,
                                  device=x_local.device)).reshape(-1)
    n_local = flat.shape[0]
    k = max(int(n_local * mesh.world() * ratio), 1)
    cand = torch.topk(flat.detach(), min(k, n_local)).values
    every = mesh.all_gather(cand)                          # (world, k_local)
    top = torch.topk(every.reshape(-1), k).values
    t = top[-1]
    # every element above t is among its rank's candidates, so the counts
    # above t are exact; a rank's count of ties among its candidates may
    # fall short of its true count only when it alone fills k
    ties = (every == t).sum(1)
    need = k - (every > t).sum()
    before = (torch.cumsum(ties, 0) - ties)[mesh.rank()]
    take = (need - before).clamp(min=0)
    at_t = flat.detach() == t
    sel = (flat.detach() > t) | (at_t & (torch.cumsum(at_t, 0) <= take))
    sel = sel & torch.isfinite(flat.detach())
    count = torch.isfinite(top).sum().clamp(min=1)
    return (torch.where(sel, flat, torch.zeros_like(flat)).sum()
            / count.to(flat.dtype))
