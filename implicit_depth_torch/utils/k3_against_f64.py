"""K3's f32 gradients, and its plain version's, against the plain version in
float64, on one NVIDIA GPU: whether the two f32 results differ by the order
of their sums or by a fault of the kernel.

    python3 -m implicit_depth_torch.utils.k3_against_f64 [--out FILE]

The operands are those of ``tests/test_torch_port_cuda.py::_width_bwd``
(seed 81, 4,000 rays of 8 pair slots, random cotangents, the default
widths or W3's rgb_out 64: roi features 256), over a voxel table of 30
cells (1,067 pair rows a cell) and of 146 (219 a cell, the default model's
rows a cell at the training step). For each of K3's three instances (from
K2's saves, recomputing layer 1, from K2 'all''s full saves) it prints one
JSON line a gradient: the relative norm of the difference of K3 (f32) and
of ``ray_decode_bwd_plain`` (f32) from ``ray_decode_bwd_plain`` in float64
(the same function, every sum in float64, from no saves), and of K3 from
the f32 plain version; and ``f64_jitter``, the most the float64 gradient
moves when the voxel table and the ray features are multiplied by 1 +
JITTER * N(0, 1) (JITTERS seeds; JITTER 2^-20, sixteen f32 ulps, about
the rounding difference of two f32 orders of a 640-term dot product,
~sqrt(640) ulps of its terms): how far the function's own gradient is
determined at f32's resolution (a LeakyReLU or soft-clamp input within
rounding of its kink takes either slope). Where K3's distance from
float64 is within a small factor of the plain version's, or of that
jitter, the two f32 results differ by summation order; where it is not,
K3 computes something else.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

# the widths of _width_bwd's cases: the default model, W3 (rgb_out 64)
WIDTHS = {"default": {}, "W3": {"c_roi": 256}}
TABLES = (30, 146)
INSTANCES = {"from saves": "l1", "recompute": None, "from full saves": "all"}
JITTERS, JITTER = 4, 2.0 ** -20


def _mlp_weights(rng, prefix, in_dim, gf4, w):
    dims = [(in_dim, gf4), (gf4, gf4 // 2), (gf4 // 2, gf4 // 4),
            (gf4 // 4, 1)]
    for i, (a, b) in enumerate(dims, 1):
        w[f"{prefix}w{i}"] = rng.normal(size=(a, b)) / np.sqrt(a)
        w[f"{prefix}b{i}"] = 0.1 * rng.normal(size=(b,))


def decode_case(rng, dev, n=4000, cv=128, c_roi=128, c_dir=27, n_table=30,
                gf=64, kb=8, multires=8):
    """f32 operands, inputs and cotangents drawn as
    test_torch_port_cuda.py's _decode_case draws them."""
    from implicit_depth_torch.ops import decode_common as common
    from implicit_depth_torch.ops import ray_decode as rd

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a)).to(dev, dtype)

    c_embed = cv + c_roi + 6 * (1 + 2 * multires) + c_dir
    w = {"off_enc_w": rng.normal(size=(1, 16)),
         "off_enc_b": 0.1 * rng.normal(size=(16,))}
    _mlp_weights(rng, "off_", c_embed + 16, 4 * gf, w)
    _mlp_weights(rng, "prob_", c_embed, 4 * gf, w)
    for pre, bias in (("off_", 0.25), ("prob_", 0.5)):  # outputs in (0, 1)
        w[f"{pre}w4"] *= 0.25
        w[f"{pre}b4"] = np.full((1,), bias)
    w32 = common.pad_operands(rd.split_ray_decode_weights(
        {k: t(v) for k, v in w.items()}, cv, c_roi, c_dir, multires,
        torch.float32), rd.FORMAT)
    args = (common.pad_columns(t(rng.normal(size=(n_table, cv))),
                               w32["dims"][0]),
            t(rng.integers(0, n_table, (n, kb)), torch.int32),
            t(0.6 * rng.normal(size=(n, kb, 6))),
            t(rng.normal(size=(n, c_roi + c_dir))))
    cot = (t(rng.normal(size=(n, kb))), t(rng.normal(size=(n, kb))))
    return w32, args, cot


def rel(a, b):
    a, b = a.double(), b.double()
    return ((a - b).norm() / b.norm().clamp(min=1e-300)).item()


def named(grads):
    """ray_decode_bwd's (d_table, d_ray_feat, {operand: gradient}) by name."""
    return {"d_table": grads[0], "d_ray_feat": grads[1], **grads[2]}


def f64_reference(args, w32, cot, jitters=JITTERS):
    """The plain decode's gradients in float64 at ``args`` (the operands of
    ray_decode_bwd but the saves) and the most each moves, over
    ``jitters`` seeds, when the voxel table and the ray features are
    multiplied by 1 + JITTER * N(0, 1): ({name: gradient}, {name: relative
    movement})."""
    from implicit_depth_torch.ops import ray_decode as rd
    ref = named(rd.ray_decode_bwd_plain(*args, w32, *cot,
                                        dtype=torch.float64))
    moved = {k: 0.0 for k in ref}
    for j in range(jitters):
        gen = torch.Generator(device=args[0].device).manual_seed(j)
        aj = list(args)
        for i in (0, 3):  # the voxel table, the ray features
            aj[i] = args[i].double() * (1 + JITTER * torch.randn(
                args[i].shape, generator=gen, device=args[i].device,
                dtype=torch.float64))
        got = named(rd.ray_decode_bwd_plain(*aj, w32, *cot,
                                            dtype=torch.float64))
        for k, g in got.items():
            moved[k] = max(moved[k], rel(g, ref[k]))
    return ref, moved


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    from implicit_depth_torch.ops import decode_common as common
    from implicit_depth_torch.ops import ray_decode as rd
    if not torch.cuda.is_available():
        raise SystemExit("k3_against_f64: needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    # chip_smoke's chunking of the card tests: several chunks, Pass B splits
    rd.K3_CHUNK_RAYS, rd.K3_SPLIT_ROWS = 1500, 1000
    lines = []
    for wname, wd in WIDTHS.items():
        for n_table in TABLES:
            w32, a, cot = decode_case(np.random.default_rng(81), dev,
                                      n_table=n_table, **wd)
            w = common.cast_operands(w32, rd.FORMAT, torch.float32)
            exact, jitter = f64_reference(a, w32, cot)
            for inst, saves_of in INSTANCES.items():
                fwd = {"l1": rd.ray_decode_save,
                       "all": rd.ray_decode_save_all}.get(saves_of)
                saves = fwd(*a, w)[2] if fwd else None
                k3 = rd.ray_decode_bwd(*a, w, saves, *cot)
                p32 = rd.ray_decode_bwd_plain(*a, w32, *cot,
                                              dtype=torch.float32,
                                              saved=saves)
                torch.cuda.synchronize()
                got, plain = named(k3), named(p32)
                for k in got:
                    line = {"width": wname, "table_cells": n_table,
                            "instance": inst, "grad": k,
                            "k3_vs_f64": rel(got[k], exact[k]),
                            "plain32_vs_f64": rel(plain[k], exact[k]),
                            "k3_vs_plain32": rel(got[k], plain[k]),
                            "f64_jitter": jitter[k]}
                    lines.append(line)
                    print(json.dumps(line), flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0)}), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(json.dumps(x) for x in lines) + "\n")


if __name__ == "__main__":
    main()
