"""Segment max-pool with a static segment count (kernel K5).

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


def _segment_max0_cuda(data: torch.Tensor, segment_ids: torch.Tensor,
                       num_segments: int,
                       valid: torch.Tensor | None) -> torch.Tensor:
    if data.dim() != 2 or data.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"segment_max0 kernel takes (N, C) f32/bf16 data, "
                         f"got {tuple(data.shape)} {data.dtype}")
    n, c = data.shape
    if segment_ids.shape != (n,) or (valid is not None and valid.shape != (n,)):
        raise ValueError("segment_ids / valid must be (N,)")
    data = data.contiguous()
    ids = segment_ids.to(torch.int32).contiguous()
    vmask = None if valid is None else valid.to(torch.uint8).contiguous()
    table = torch.zeros((num_segments, c), dtype=torch.float32,
                        device=data.device)
    fn = cuda.bind("segment_max", "idt_segment_max", *[cuda.PTR] * 4,
                   *[cuda.I64] * 4)
    cuda.check(fn(data.data_ptr(), ids.data_ptr(), cuda.ptr(vmask),
                  table.data_ptr(), n, c, num_segments,
                  int(data.dtype == torch.bfloat16),
                  cuda.stream_ptr(data.device)), "segment_max")
    return table.to(data.dtype)


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
    out = _SegmentMax0.apply(data, segment_ids, num_segments, valid)
    segment_max0.launches += 1
    return out


segment_max0.launches = 0
