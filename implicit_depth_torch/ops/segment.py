"""Segment max-pool with a static segment count (kernel K5), and the segment
sum of the pair decode's recompute backward.

Counterpart of ``implicit_depth_tpu/ops/segment.py::segment_max0`` (the plain
reduction) and ``ops/pallas_segment.py::pallas_segment_max0`` (its TPU
kernel). It replaces the reference's ``torch_scatter.scatter(reduce='max')``
in the PointNet voxel max-pool: max over the valid rows of each segment,
exactly 0 for an empty segment.

:func:`segment_max0` is the wrapper the models call. On a CPU tensor it runs
:func:`segment_max0_plain`; on a CUDA tensor it launches the CUDA kernel
``csrc/segment_max.cu`` and counts the launch in ``segment_max0.launches``.
The kernel's contract, like the TPU kernel's, is NON-NEGATIVE data (post-ReLU
features), where it is exact.

The kernel's gradient (:class:`_SegmentMax0`) is plain PyTorch, as the JAX
package trains through ``jax.ops.segment_max`` and has no backward kernel.
It follows JAX's rule: a segment's cotangent is shared equally among all
valid rows that tie at its maximum (post-ReLU zeros tie often); invalid rows
and empty segments get nothing.

:func:`segment_sum_` adds rows into an f32 table by key, in an order fixed
by a sort of the keys (:func:`chunk_sort`): on a CUDA tensor two launches of
``csrc/segment_sum.cu`` (no atomics, the same bits every run), on a CPU
tensor :func:`segment_sum_plain_`, which repeats the kernel's order. Its
counters: ``segment_sum_.launches`` (kernel launches) and
``segment_sum_.rows`` (rows reduced).
"""

from __future__ import annotations

import torch

from implicit_depth_torch.ops import cuda


def segment_max0_plain(data: torch.Tensor, segment_ids: torch.Tensor,
                       num_segments: int,
                       valid: torch.Tensor | None = None) -> torch.Tensor:
    """(N, C) rows -> (num_segments, C) max over the valid rows of each
    segment; empty segments are exactly 0. Any sign of data."""
    ids = segment_ids.long()
    if valid is not None:
        data = torch.where(valid[:, None], data,
                           torch.full((), float("-inf"), dtype=data.dtype,
                                      device=data.device))
        ids = torch.where(valid, ids, torch.zeros_like(ids))
    out = torch.full((num_segments, data.shape[1]), float("-inf"),
                     dtype=data.dtype, device=data.device)
    out.scatter_reduce_(0, ids[:, None].expand_as(data), data, "amax")
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))


_KERNEL = None  # the bound C function, looked up at the first call


def _kernel():
    global _KERNEL
    if _KERNEL is None:
        _KERNEL = cuda.bind("segment_max", "idt_segment_max", *[cuda.PTR] * 5,
                            *[cuda.I64] * 4)
    return _KERNEL


def _segment_max0_cuda(data: torch.Tensor, segment_ids: torch.Tensor,
                       num_segments: int,
                       valid: torch.Tensor | None) -> torch.Tensor:
    """One C call: it zeroes an f32 table, merges the rows into it and, for
    bf16 data, writes it out in bf16 (f32 data merges straight into the
    output). ``valid`` is read as the bool tensor's bytes; int32 ids and
    contiguous data are used as they are, so a call from the models makes no
    launch from Python but this one."""
    if data.dim() != 2 or data.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"segment_max0 kernel takes (N, C) f32/bf16 data, "
                         f"got {tuple(data.shape)} {data.dtype}")
    n, c = data.shape
    if segment_ids.shape != (n,) or (valid is not None and valid.shape != (n,)):
        raise ValueError("segment_ids / valid must be (N,)")
    data = data.contiguous()
    ids = segment_ids.to(torch.int32).contiguous()
    vmask = None if valid is None else \
        valid.to(torch.bool).contiguous().view(torch.uint8)
    out = torch.empty((num_segments, c), dtype=data.dtype, device=data.device)
    table = None if data.dtype == torch.float32 else torch.empty(
        (num_segments, c), dtype=torch.float32, device=data.device)
    cuda.check(_kernel()(data.data_ptr(), ids.data_ptr(), cuda.ptr(vmask),
                         out.data_ptr(), cuda.ptr(table), n, c, num_segments,
                         int(data.dtype == torch.bfloat16),
                         cuda.stream_ptr(data.device)), "segment_max")
    return out


def segment_max0_grad(data: torch.Tensor, segment_ids: torch.Tensor,
                      valid: torch.Tensor | None, out: torch.Tensor,
                      grad: torch.Tensor) -> torch.Tensor:
    """d data (N, C) of :func:`segment_max0` given its output ``out`` and
    cotangent ``grad`` (S, C): each segment's cotangent split equally among
    the valid rows equal to its maximum. A row of an empty segment cannot be
    valid, so empty segments pass nothing on."""
    ids = segment_ids.long()
    tie = data == out[ids]
    if valid is not None:
        tie &= valid[:, None]
    tie = tie.float()
    n_tie = torch.zeros(out.shape, dtype=torch.float32, device=data.device)
    n_tie.index_add_(0, ids, tie)
    share = grad.float() / n_tie.clamp(min=1.0)
    return (tie * share[ids]).to(data.dtype)


class _SegmentMax0(torch.autograd.Function):
    """Kernel K5 forward, plain-PyTorch backward."""

    @staticmethod
    def forward(ctx, data, segment_ids, num_segments, valid):
        out = _segment_max0_cuda(data, segment_ids, num_segments, valid)
        ctx.save_for_backward(data, segment_ids, valid, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        data, segment_ids, valid, out = ctx.saved_tensors
        return segment_max0_grad(data, segment_ids, valid, out, grad), \
            None, None, None


def segment_max0(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int,
                 valid: torch.Tensor | None = None) -> torch.Tensor:
    """Max-pool NON-NEGATIVE rows of ``data`` (N, C) into ``num_segments``
    buckets; invalid rows are excluded and empty segments are exactly 0.
    CPU tensors take the plain version; CUDA tensors take kernel K5 (with
    its gradient)."""
    if data.device.type == "cpu":
        return segment_max0_plain(data, segment_ids, num_segments, valid)
    if data.device.type != "cuda":
        raise ValueError(f"segment_max0: no kernel for device {data.device}")
    if torch.is_grad_enabled() and data.requires_grad:
        out = _SegmentMax0.apply(data, segment_ids, num_segments, valid)
    else:  # no graph to record: skip the autograd Function's host work
        out = _segment_max0_cuda(data, segment_ids, num_segments, valid)
    segment_max0.launches += 1
    return out


segment_max0.launches = 0


# -- segment sum in a fixed order ------------------------------------------

# csrc/segment_sum.cu's kTileRows and kGroups: the order of its sums
SUM_TILE_ROWS = 64
SUM_GROUPS = 16


def chunk_sort(index: torch.Tensor, chunk: int,
               num_segments: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One stable sort of rows by (chunk, index): ``index`` (n,) in [0,
    num_segments), the rows cut into chunks of ``chunk`` in order. Returns
    (keys, order), each (n,) int64, chunk c's at sorted positions [c·chunk,
    (c + 1)·chunk) and local to it: ``keys`` the rows' index, ascending,
    ``order`` the rows' positions in the chunk. No host sync."""
    n = index.shape[0]
    keys, order = torch.sort(torch.arange(n, device=index.device) // chunk
                             * num_segments + index.long(), stable=True)
    return keys % num_segments, order % chunk


def segment_sum_plain_(table: torch.Tensor, rows: torch.Tensor,
                       keys: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """:func:`segment_sum_` in PyTorch, with the kernel's order of f32 sums:
    the sorted positions in tiles of :data:`SUM_TILE_ROWS`, each run of one
    key in a tile summed from 0 in order; a segment whole in a tile added to
    its row; one that crosses tiles added as the sum over
    :data:`SUM_GROUPS` groups (piece i in group i % groups, each from 0 in
    order; the groups in order from 0) of its pieces in tile order. Any
    device; returns ``table``."""
    n, c = keys.shape[0], table.shape[1]
    if n == 0:
        return table
    t, dev = SUM_TILE_ROWS, table.device
    tiles = -(-n // t)
    seg = keys
    vals = rows.float()[order]
    pad = tiles * t - n
    vals = torch.nn.functional.pad(vals, (0, 0, 0, pad)).reshape(tiles, t, c)
    seg_t = torch.nn.functional.pad(seg, (0, pad), value=-1).reshape(tiles, t)
    new = torch.ones_like(seg_t, dtype=torch.bool)
    new[:, 1:] = seg_t[:, 1:] != seg_t[:, :-1]
    sums = torch.empty_like(vals)
    acc = torch.zeros((tiles, c), device=dev)
    for j in range(min(t, n)):  # each tile's runs, row by row
        acc = torch.where(new[:, j, None], torch.zeros((), device=dev),
                          acc) + vals[:, j]
        sums[:, j] = acc
    pos = torch.arange(n, device=dev)
    tile = pos // t
    end = torch.ones(n, dtype=torch.bool, device=dev)
    end[:-1] = seg[1:] != seg[:-1]
    tile_end = (pos % t == t - 1) | (pos == n - 1)
    end |= tile_end
    first_run = new.cumsum(1).reshape(-1)[:n] == 1
    starts = torch.arange(tiles, device=dev) * t
    lasts = (starts + t).clamp(max=n) - 1
    open_start = (starts > 0) & (seg[(starts - 1).clamp(min=0)] == seg[starts])
    open_end = (lasts + 1 < n) & (seg[(lasts + 1).clamp(max=n - 1)]
                                  == seg[lasts])
    is_open = (first_run & open_start[tile]) | (tile_end & open_end[tile])
    sums = sums.reshape(-1, c)[:n]
    whole = end & ~is_open
    table[seg[whole]] += sums[whole]
    piece = end & is_open
    part = torch.zeros((tiles, 2, c), device=dev)
    part[tile[piece], (~first_run[piece]).long()] = sums[piece]
    # each crossing segment's owner: the tile it starts in
    single = seg[starts] == seg[lasts]
    owner = open_end & ~(single & open_start)
    a = owner.nonzero()[:, 0]
    if a.numel() == 0:
        return table
    s = seg[lasts[a]]
    last_tile = torch.searchsorted(seg[starts].contiguous(), s,
                                   right=True) - 1
    pieces = last_tile - a + 1
    groups = torch.zeros((a.shape[0], SUM_GROUPS, c), device=dev)
    for i in range(int(pieces.max())):
        p = part[a, (~single[a]).long()] if i == 0 \
            else part[(a + i).clamp(max=tiles - 1), 0]
        g = i % SUM_GROUPS
        groups[:, g] = torch.where((i < pieces)[:, None], groups[:, g] + p,
                                   groups[:, g])
    total = torch.zeros((a.shape[0], c), device=dev)
    for g in range(SUM_GROUPS):
        total = total + groups[:, g]
    table[s] += total
    return table


_SUM_KERNEL = None  # the bound C function, looked up at the first call


def _sum_kernel():
    global _SUM_KERNEL
    if _SUM_KERNEL is None:
        _SUM_KERNEL = cuda.bind("segment_sum", "idt_segment_sum",
                                *[cuda.PTR] * 5, *[cuda.I64] * 3)
    return _SUM_KERNEL


def segment_sum_(table: torch.Tensor, rows: torch.Tensor, keys: torch.Tensor,
                 order: torch.Tensor) -> torch.Tensor:
    """Add ``rows`` (n, C), f32 or bf16, into ``table`` (S, C) f32 by key,
    summed in f32 in a fixed order (the same bits every run): the i-th
    sorted row ``rows[order[i]]`` goes to table row ``keys[i]``. ``keys``
    (n,) ascending in [0, S) and ``order`` (n,) a permutation of [0, n),
    int64, as a chunk of :func:`chunk_sort`'s. CPU tensors take
    :func:`segment_sum_plain_`; CUDA tensors
    ``csrc/segment_sum.cu`` (two launches, none for n = 0), with no host
    sync. Returns ``table``."""
    n = keys.shape[0]
    if table.dim() != 2 or table.dtype != torch.float32 \
            or rows.dim() != 2 or rows.shape != (n, table.shape[1]) \
            or order.shape != (n,):
        raise ValueError(f"segment_sum_: table (S, C) f32, rows (n, C), keys "
                         f"and order (n,); got {tuple(table.shape)} "
                         f"{table.dtype}, {tuple(rows.shape)}, "
                         f"{tuple(keys.shape)}, {tuple(order.shape)}")
    segment_sum_.rows += n
    if table.device.type == "cpu":
        return segment_sum_plain_(table, rows, keys, order)
    if table.device.type != "cuda" or rows.dtype not in (torch.float32,
                                                         torch.bfloat16):
        raise ValueError(f"segment_sum_: no kernel for {rows.dtype} rows on "
                         f"{table.device}")
    if not table.is_contiguous():
        raise ValueError("segment_sum_: the table must be contiguous")
    if n == 0:
        return table
    rows = rows.contiguous()
    keys = keys.to(torch.int64).contiguous()
    order = order.to(torch.int64).contiguous()
    part = torch.empty((-(-n // SUM_TILE_ROWS), 2, table.shape[1]),
                       dtype=torch.float32, device=table.device)
    cuda.check(_sum_kernel()(rows.data_ptr(), keys.data_ptr(),
                             order.data_ptr(), table.data_ptr(),
                             part.data_ptr(), n, table.shape[1],
                             int(rows.dtype == torch.bfloat16),
                             cuda.stream_ptr(table.device)), "segment_sum")
    segment_sum_.launches += 2
    return table


segment_sum_.launches = 0
segment_sum_.rows = 0
