"""Dilated ResNet34 with output stride 8 and a 1×1 feature head
(counterpart of ``implicit_depth_tpu/models/resnet.py::ResNet34_8s``).

Once the running stride reaches 8, later stride-2 stages keep stride 1 and
multiply their dilation instead (layer3 -> dilation 2, layer4 -> 4; 3×3
convs pad by the dilation). A 1×1 conv maps to ``out_ch`` and the map is
bilinearly resized back to the input size (align_corners=False).
Convolutions run in the compute dtype; BatchNorm (eps 1e-5) runs in f32, as
flax's ``BatchNorm(dtype=float32)``: in eval mode on the running statistics,
in train mode (``.train()``) on the batch's mean and biased variance
E[x²] - E[x]², updating the running statistics as flax does with momentum
0.9 (ra = 0.9·ra + 0.1·batch statistic, the biased variance included).
Input and output are NHWC, as in the JAX module.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from implicit_depth_torch.models.init import normal_


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


def _bn_f32(x, bn: nn.BatchNorm2d):
    x = x.float()
    if not bn.training:
        return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                            bn.bias, False, 0.0, bn.eps)
    # F.batch_norm(training=True) would update running_var with the unbiased
    # variance; flax keeps the biased one, so the statistics are done here
    mean = x.mean((0, 2, 3))
    var = ((x * x).mean((0, 2, 3)) - mean * mean).clamp(min=0)
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
        x = F.interpolate(x, size=(in_h, in_w), mode="bilinear",
                          align_corners=False)
        return x.permute(0, 2, 3, 1)
