"""Dilated ResNet34 with output stride 8 and a 1×1 feature head
(counterpart of ``implicit_depth_tpu/models/resnet.py::ResNet34_8s``).

Once the running stride reaches 8, later stride-2 stages keep stride 1 and
multiply their dilation instead (layer3 -> dilation 2, layer4 -> 4; 3×3
convs pad by the dilation). A 1×1 conv maps to ``out_ch`` and the map is
bilinearly resized back to the input size (align_corners=False; the
gradient of the resize is two products with its interpolation matrices,
which sum in a fixed order, where PyTorch's CUDA backward adds with
atomics and so differs from run to run).
Convolutions run in the compute dtype; BatchNorm (eps 1e-5) runs in f32, as
flax's ``BatchNorm(dtype=float32)``: in eval mode on the running statistics,
in train mode (``.train()``) on the batch's mean and biased variance
E[x²] - E[x]², updating the running statistics as flax does with momentum
0.9 (ra = 0.9·ra + 0.1·batch statistic, the biased variance included).
Under a process group of several data blocks the train-mode statistics
are the global batch's (the JAX step's, taken over the global array), the
same on every rank, and so are the running statistics.
Input and output are NHWC, as in the JAX module.
:func:`remat` checkpoints the whole network as one unit
(``tpu.remat_backbone``): its activations are recomputed in the backward,
and the recompute leaves the running statistics alone.
"""

from __future__ import annotations

import contextlib
import math
from typing import Sequence

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_fn
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from implicit_depth_torch.models.init import normal_
from implicit_depth_torch.parallel import mesh
from implicit_depth_torch.utils import profiling


def bilinear_matrix(n_out: int, n_in: int) -> torch.Tensor:
    """(n_out, n_in) f32 on the CPU: row o holds the weights with which
    ``F.interpolate(mode="bilinear", align_corners=False)`` mixes the input
    rows into output row o (source (o + 0.5)·n_in/n_out - 0.5 clamped at 0,
    its floor and the next row, clamped at the last)."""
    src = ((torch.arange(n_out, dtype=torch.float32) + 0.5)
           * (n_in / n_out) - 0.5).clamp(min=0)
    i0 = src.long()
    lam = src - i0
    a = torch.zeros(n_out, n_in)
    rows = torch.arange(n_out)
    a[rows, i0] += 1 - lam
    a[rows, (i0 + 1).clamp(max=n_in - 1)] += lam
    return a


class _BilinearResize(torch.autograd.Function):
    """``F.interpolate`` bilinear (align_corners=False) to ``size``, whose
    backward is A_hᵀ·g·A_w (``bilinear_matrix``) in f32: products that sum
    in a fixed order."""

    @staticmethod
    def forward(ctx, x, size):
        ctx.in_hw, ctx.dtype = x.shape[-2:], x.dtype
        return F.interpolate(x, size=size, mode="bilinear",
                             align_corners=False)

    @staticmethod
    def backward(ctx, g):
        (h_out, w_out), (h_in, w_in) = g.shape[-2:], ctx.in_hw
        with profiling.span("sync.resize_matrices"):  # pageable copies
            a_h = bilinear_matrix(h_out, h_in).to(g.device)
            a_w = bilinear_matrix(w_out, w_in).to(g.device)
        return (a_h.t() @ (g.float() @ a_w)).to(ctx.dtype), None


def _conv(cin, cout, k, stride, pad, dil, generator, bias=False):
    conv = nn.Conv2d(cin, cout, k, stride=stride, padding=pad, dilation=dil,
                     bias=bias)
    normal_(conv.weight, math.sqrt(2.0 / (cout * k * k)), generator)  # kaiming fan-out
    return conv


def _bn(c):
    return nn.BatchNorm2d(c, eps=1e-5, momentum=0.1)


def _conv_dt(x, conv: nn.Conv2d, dtype):
    b = None if conv.bias is None else conv.bias.to(dtype)
    return F.conv2d(x.to(dtype), conv.weight.to(dtype), b, conv.stride,
                    conv.padding, conv.dilation)


_MOMENTUM = 0.9  # flax's: the running statistics keep 0.9 of themselves


def _global_moments(x):
    """(E[x], E[x²]) per channel over the global batch: each rank's (Σx,
    Σx²) all-reduced over its data group (``parallel/mesh.py``: the ranks
    of its ray index, which hold one copy of each image), over the count
    of ``data`` ranks' elements. The all-reduce's backward sums the data
    group's incoming gradients, so each rank's input gradient is that of
    the global statistics. Every rank holds a batch of the same shape.

    Under the ``rays`` axis the ranks of a rays group hold the same images
    and each takes its share L_(d,i) of the loss over its block i of the
    rays. L = Σ_i L_i, L_i = Σ_d L_(d,i): the ranks of ray index i are a
    data-parallel group computing L_i, whose gradients summed over that
    group are dL_i/dθ (the one-axis case); summing over every rank
    (``all_reduce_grads``) adds the ray indices' and gives dL/dθ. Counting
    each copy of an image in one all-reduce over every rank gives the same
    moments and gradient in exact arithmetic, but sums the copies in
    another order: its activations differed from one process by ~1e-6 on
    the CPU and a ReLU input 3e-6 from its kink took the other branch,
    moving the ResNet's gradients by up to 25% (a 4-rank test against
    JAX); over the data group the sums are those of the data-parallel
    layout of the same blocks."""
    c = x.shape[1]
    sums = torch.cat([x.sum((0, 2, 3)), (x * x).sum((0, 2, 3))])
    data = mesh.current().data
    if data > 1:
        _global_moments.calls += 1
        sums = dist_fn.all_reduce(sums, group=mesh.data_group()
                                  or dist.group.WORLD)
    n = x.numel() // c * data
    return sums[:c] / n, sums[c:] / n


_global_moments.calls = 0  # the moments' all-reduces (forward) under a group


class _Recompute:
    """Set while :func:`remat` recomputes the forward in the backward. A
    flag of the process, not of a thread: the CUDA backward runs on the
    autograd engine's own thread."""

    active = False


@contextlib.contextmanager
def _recomputing():
    _Recompute.active = True
    try:
        yield
    finally:
        _Recompute.active = False


def remat(resnet: "ResNet34_8s", x: torch.Tensor, dtype) -> torch.Tensor:
    """``resnet(x, dtype)`` checkpointed as one unit (the JAX package's
    ``nn.remat(ResNet34_8s)``): only its input is kept for the backward,
    which runs the forward again and differentiates that. The recompute
    makes the same operations in the same order (under a process group the
    BatchNorm moments' all-reduce too, on every rank), so the gradients are
    the bits of the plain forward's; the running statistics move once, in
    the forward, as flax throws the recompute's updates away. Without
    autograd it is the plain call."""
    if not torch.is_grad_enabled():
        return resnet(x, dtype)
    # preserve_rng_state: the network draws no random number
    return torch.utils.checkpoint.checkpoint(
        resnet, x, dtype, use_reentrant=False, preserve_rng_state=False,
        context_fn=lambda: (contextlib.nullcontext(), _recomputing()))


def _bn_f32(x, bn: nn.BatchNorm2d):
    x = x.float()
    if not bn.training:
        return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                            bn.bias, False, 0.0, bn.eps)
    # F.batch_norm(training=True) would update running_var with the unbiased
    # variance; flax keeps the biased one, so the statistics are done here
    if mesh.current().data > 1:
        mean, ex2 = _global_moments(x)
    else:
        mean, ex2 = x.mean((0, 2, 3)), (x * x).mean((0, 2, 3))
    var = (ex2 - mean * mean).clamp(min=0)
    if not _Recompute.active:  # the forward updates them, its recompute not
        with torch.no_grad():
            bn.running_mean.mul_(_MOMENTUM).add_(mean, alpha=1 - _MOMENTUM)
            bn.running_var.mul_(_MOMENTUM).add_(var, alpha=1 - _MOMENTUM)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    return (x - mean[:, None, None]) * mul[:, None, None] + bn.bias[:, None, None]


class BasicBlock(nn.Module):
    def __init__(self, inplanes, planes, stride=1, dilation=1,
                 downsample=False, generator=None):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 3, stride, dilation, dilation, generator)
        self.bn1 = _bn(planes)
        self.conv2 = _conv(planes, planes, 3, 1, dilation, dilation, generator)
        self.bn2 = _bn(planes)
        self.down_conv = (_conv(inplanes, planes, 1, stride, 0, 1, generator)
                          if downsample else None)
        self.down_bn = _bn(planes) if downsample else None

    def forward(self, x, dtype):
        y = F.relu(_bn_f32(_conv_dt(x, self.conv1, dtype), self.bn1))
        y = _bn_f32(_conv_dt(y, self.conv2, dtype), self.bn2)
        res = x
        if self.down_conv is not None:
            res = _bn_f32(_conv_dt(x, self.down_conv, dtype), self.down_bn)
        return F.relu(y + res)


class ResNet34_8s(nn.Module):
    def __init__(self, out_ch: int = 32, inp_ch: int = 3,
                 stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 output_stride: int = 8,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.conv1 = _conv(inp_ch, 64, 7, 2, 3, 1, generator)
        self.bn1 = _bn(64)
        self.block_names = []
        current_stride, dilation, inplanes = 4, 1, 64
        for stage, (blocks, planes) in enumerate(
                zip(stage_sizes, (64, 128, 256, 512))):
            stride = 1 if stage == 0 else 2
            if stride != 1 and current_stride == output_stride:
                dilation *= stride
                stride = 1
            else:
                current_stride *= stride
            for i in range(blocks):
                needs_down = i == 0 and (stride != 1 or inplanes != planes)
                name = f"layer{stage + 1}_{i}"
                self.add_module(name, BasicBlock(
                    inplanes, planes, stride if i == 0 else 1, dilation,
                    needs_down, generator))
                self.block_names.append(name)
                inplanes = planes
        self.fc = nn.Conv2d(512, out_ch, 1)
        normal_(self.fc.weight, 0.01, generator)
        nn.init.zeros_(self.fc.bias)

    def forward(self, x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
        """x (B, H, W, inp_ch) -> (B, H, W, out_ch) in ``dtype``."""
        in_h, in_w = x.shape[1], x.shape[2]
        x = x.permute(0, 3, 1, 2)
        x = F.relu(_bn_f32(_conv_dt(x, self.conv1, dtype), self.bn1))
        x = F.max_pool2d(x, 3, 2, 1)
        for name in self.block_names:
            x = getattr(self, name)(x, dtype)
        x = _conv_dt(x, self.fc, dtype)
        x = _BilinearResize.apply(x, (in_h, in_w))
        return x.permute(0, 2, 3, 1)
