"""The program under test (``implicit_depth_torch``) set up from a
configuration file: its config object, and its models built on the meta
device and then given the benchmark's weights on the card, so that no
parameter is drawn on the host."""

from __future__ import annotations

from typing import Dict

import torch

from benchmark.harness import weights as bench_weights
from benchmark.reference import model as ref

# the configuration file's groups that the program's config takes
GROUPS = ("dataset", "model", "refine", "grid", "training", "loss", "tpu",
          "mask_type")


def config(cfg: Dict):
    from implicit_depth_torch.config import load_config
    return load_config(overrides={k: cfg[k] for k in GROUPS if k in cfg})


def make_weights(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The benchmark's weights of every model of the configuration, under
    "lidf." and (with a "refine" group) "refine."."""
    spec = [("lidf." + n, s) for n, s in ref.lidf_spec(cfg)]
    last = {"lidf.offset_dec.": 0.5 / cfg["model"]["n_iter"],
            "lidf.prob_dec.": 0.5}
    if "refine" in cfg:
        spec += [("refine." + n, s) for n, s in ref.refine_spec(cfg)]
        last["refine.offset_dec."] = 0.5 / cfg["refine"]["n_iter"]
    return bench_weights.make(spec, seed, device, last)


def models(cfg: Dict, pcfg, static, w: Dict[str, torch.Tensor], device):
    """(stage 1, RefineNet or None) of the program with the weights ``w``
    (:func:`make_weights`), on ``device``."""
    from implicit_depth_torch.builder import build_lidf, build_refine
    with torch.device("meta"):
        lidf = build_lidf(pcfg, static)
        refine = build_refine(pcfg, static) if "refine" in cfg else None
    out = []
    for m, pre in ((lidf, "lidf."), (refine, "refine.")):
        if m is None:
            out.append(None)
            continue
        m = m.to_empty(device=device)
        m.load_state_dict(bench_weights.split(w, pre), strict=True)
        out.append(m)
    return tuple(out)
