"""Seeded weights, made on the device in one draw.

Every parameter of a specification [(name, shape)] is cut from one
``torch.randn`` of a ``torch.Generator`` on the device seeded with the
run's seed, at unit activation scale: Dense and Conv kernels lecun-normal
(std 1/sqrt(fan-in)), biases N(0, 0.1), BatchNorm scale 1 + N(0, 0.1),
shift and running mean N(0, 0.1), running variance 0.5 + 0.5·|N(0, 1)|.
The ResNet's 1×1 head and each decoder's last layer take a quarter of that
scale, the last layer's bias set so that the raw decoder output sits near
0.5 (0.5 / n_iter for an IEF decoder), inside the soft clamp's
near-identity range. The same seed gives the same tensors to the program
and to the reference.
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, Tuple

import torch

_BN = re.compile(r"(^|\.)(bn\d*|down_bn)\.(weight|bias|running_mean|running_var)$")


def make(spec: List[Tuple[str, tuple]], seed: int, device,
         last_bias: Dict[str, float]) -> Dict[str, torch.Tensor]:
    """{name: f32 tensor} for ``spec``; ``last_bias``: {prefix of a decoder:
    the bias of its last layer}."""
    floats = [(n, s) for n, s in spec if not n.endswith("num_batches_tracked")]
    total = sum(math.prod(s) for _, s in floats)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape in spec:
        if name.endswith("num_batches_tracked"):
            out[name] = torch.zeros(shape, dtype=torch.long, device=device)
            continue
        n = math.prod(shape)
        x = flat[at:at + n].reshape(shape)
        at += n
        bn = _BN.search(name)
        if bn:
            kind = bn.group(3)
            x = {"weight": 1.0 + 0.1 * x, "bias": 0.1 * x,
                 "running_mean": 0.1 * x,
                 "running_var": 0.5 + 0.5 * x.abs()}[kind]
        elif name.endswith(".weight"):
            x = x / math.sqrt(math.prod(shape[1:]))
            if name.endswith("resnet.fc.weight") or name.endswith("mlp.l3.weight"):
                x = 0.25 * x
        else:
            x = 0.1 * x
            for pre, b in last_bias.items():
                if name == pre + "mlp.l3.bias":
                    x = torch.full_like(x, b)
        out[name] = x.contiguous()
    return out


def split(weights: Dict[str, torch.Tensor], prefix: str):
    """The entries under ``prefix`` with it cut off."""
    return {k[len(prefix):]: v for k, v in weights.items()
            if k.startswith(prefix)}
