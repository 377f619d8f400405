"""The work a cell needs, counted from the configuration's widths and the
cell's shapes, never from the program's operands: the stage-1 per-ray
decode's operations and bytes (its roofline), and the model's operations
a call or a step (its MFU), with the peaks of ``peaks.json``.

The decode of N rays × kb pair slots, with decoder layers g1 = 4·imnet_gf
-> g2 = 2·imnet_gf -> g3 = imnet_gf -> 1: layer 1 of both decoders over
each pair's [voxel feature | enc(enter) | enc(leave)] columns, the
per-ray [ROI | enc(dir)] columns once a ray, two IEF tails and the
probability decoder's tail a pair. A backward is counted as twice its
forward's products. Bytes: each input read once (the voxel table, the
cells, the positions, the per-ray features, the weights) and each output
written once, in the compute dtype; a backward reads the forward's inputs
and the outputs' gradients and writes the inputs' gradients in f32.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict

PEAKS = json.loads((Path(__file__).resolve().parents[1] / "peaks.json"
                    ).read_text())

_ESIZE = {"bfloat16": 2, "float32": 4}


def peak_flops(dtype: str) -> float:
    return PEAKS["bf16_dense_flops"] if dtype == "bfloat16" \
        else PEAKS["f32_flops"]


def decode_widths(cfg: dict) -> Dict[str, int]:
    m = cfg["model"]
    g = m["imnet_gf"]
    return {"c_vox": m["pnet_out"],
            "c_pair": m["pnet_out"] + 6 + 12 * m["multires"],
            "c_ray": m["rgb_out"] * m["roi_out_bbox"] ** 2
            + 3 * (1 + 2 * m["multires_views"]),
            "g1": 4 * g, "g2": 2 * g, "g3": g,
            "n_cells": (cfg["grid"]["res"] + 1) ** 3}


def decode(cfg: dict, images: int, rays: int, backward: bool = False):
    """(operations, bytes) of the per-ray decode of ``images`` × ``rays``
    rays at the configuration's pair budget; with ``backward`` its
    gradient's added."""
    w = decode_widths(cfg)
    kb = cfg["tpu"]["pairs_budget_per_ray"]
    es = _ESIZE[cfg["tpu"]["compute_dtype"]]
    n = images * rays
    g1, g2, g3 = w["g1"], w["g2"], w["g3"]
    tail = g1 * g2 + g2 * g3 + g3
    fwd = 2 * (n * kb * (w["c_pair"] * 2 * g1 + 3 * tail)
               + n * w["c_ray"] * 2 * g1)
    n_weights = 2 * (w["c_pair"] + w["c_ray"]) * g1 + 3 * tail
    table = images * w["n_cells"] * w["c_vox"]
    inputs = (table * es + n * kb * (4 + 6 * 4) + n * w["c_ray"] * es
              + n_weights * es)
    outputs = 2 * n * kb * 4
    if not backward:
        return fwd, inputs + outputs
    grads = (table + n * w["c_ray"] + n_weights) * 4
    return 3 * fwd, 2 * inputs + 2 * outputs + grads


def least_seconds(flops: float, nbytes: float, dtype: str) -> float:
    """The least time the chip could take: the larger of the operations
    at the peak rate and the bytes at the memory's."""
    return max(flops / peak_flops(dtype), nbytes / PEAKS["hbm_bytes_per_s"])
