"""The work of the stage-1 decode over pair rows (the ``global`` and dense
modes), counted from the configuration's widths and the traffic's pairs,
never from the program's operands:

- :func:`k6`: K6's operations and bytes over the rows it decodes (its
  roofline). A row is one (voxel, ray) pair: layer 1 of both decoders over
  the pair's whole embedding [voxel feature | ROI | enc(enter) |
  enc(leave) | enc(dir)], two IEF tails and the probability decoder's
  tail (4·imnet_gf -> 2·imnet_gf -> imnet_gf -> 1). Bytes: the voxel table
  and the per-ray features read once, the weights once, each decoded row's
  cell, positions and ray index once, every row's two outputs written;
- :func:`valid_pairs`: the valid pairs a step of a cell's traffic pool,
  from the plain reference's geometry of the pool's batches with the
  checked steps' draws;
- :func:`allpairs_step_flops`: the model's operations a training step in
  which every valid pair is decoded once, forward and backward: the
  reference's count of the step (``flops.py``) with the decode of the
  slots that hold no valid pair taken out.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.harness import flops
from benchmark.harness.counts import _ESIZE, decode_widths
from benchmark.reference import geometry
from benchmark.reference import model as ref


def k6(cfg: dict, images: int, rays: int, slots: int, rows: float):
    """(operations, bytes) of K6 decoding ``rows`` of ``slots`` pair rows
    of ``images`` × ``rays`` rays."""
    w = decode_widths(cfg)
    es = _ESIZE[cfg["tpu"]["compute_dtype"]]
    g1, g2, g3 = w["g1"], w["g2"], w["g3"]
    tail = g1 * g2 + g2 * g3 + g3
    embed = w["c_pair"] + w["c_ray"]
    ops = 2 * rows * (embed * 2 * g1 + 3 * tail)
    n_weights = 2 * embed * g1 + 3 * tail
    nbytes = ((images * w["n_cells"] * w["c_vox"] + images * rays * w["c_ray"]
               + n_weights) * es
              + rows * (4 + 6 * 4 + 4) + 2 * slots * 4)
    return ops, nbytes


def valid_pairs(driver) -> float:
    """The mean valid (voxel, ray) pairs a step of ``driver``'s traffic
    pool: the reference's geometry of each of the pool's batches, drawn in
    turn from one generator seeded as the checked steps' (kept on the
    driver once counted)."""
    got = getattr(driver, "pool_valid_pairs", None)
    if got is None:
        cfg, dev = driver.cfg, driver.dev
        grid = geometry.make_grid(cfg["grid"]["res"])
        gen = torch.Generator(device=dev).manual_seed(driver.seed)
        counts = []
        with torch.no_grad():
            for hb in driver.pool:
                batch = {k: torch.as_tensor(v, device=dev)
                         for k, v in hb.items()}
                inp = geometry.prepare(
                    grid, batch, train=True,
                    n_valid=cfg["grid"]["valid_sample_num"],
                    n_rays=cfg["grid"]["miss_sample_num"],
                    k_pairs=cfg["tpu"]["max_pairs_per_ray"], gen=gen)
                counts.append(int(inp["pair_valid"].sum()))
                del inp, batch
        got = driver.pool_valid_pairs = sum(counts) / len(counts)
    return got


def pair_train_flops(cfg: dict) -> float:
    """The reference's operations, forward and backward, of decoding one
    pair slot more (``model.py::_decode_chunk`` on the meta device at two
    slots a ray less at one, every input and weight a leaf that takes a
    gradient, as in a step)."""
    dec = [(n, s) for n, s in ref.lidf_spec(cfg)
           if n.startswith(("offset_dec.", "prob_dec."))]
    w = decode_widths(cfg)
    meta = torch.device("meta")

    def count(kb: int) -> float:
        p = {n: torch.empty(s, device=meta, requires_grad=True)
             for n, s in dec}
        vox = torch.empty((1, w["c_vox"]), device=meta, requires_grad=True)
        roi_dir = torch.empty((1, w["c_ray"]), device=meta,
                              requires_grad=True)
        cells = torch.zeros((1, kb), dtype=torch.long, device=meta)
        pos = torch.empty((1, kb, 6), device=meta)
        with FlopCounterMode(display=False) as fc:
            off, logit = ref._decode_chunk(p, cfg, ref.Precision(), vox,
                                           roi_dir, cells, pos)
            torch.autograd.grad(off.sum() + logit.sum(),
                                [vox, roi_dir, *p.values()])
        return float(fc.get_total_flops())

    return count(2) - count(1)


def allpairs_step_flops(driver) -> float:
    """A stage-1 step's operations with every valid pair of the traffic
    pool decoded once: the reference's step at every slot of the
    configuration's budget (``flops.train``) less the decode of the slots
    that hold no valid pair."""
    cfg, t = driver.cfg, driver.t
    images, rays = driver.decode_images_rays()
    slots = images * rays * cfg["tpu"]["pairs_budget_per_ray"]
    whole = flops.train(cfg, t, driver.stage, driver.epoch)
    return whole - pair_train_flops(cfg) * (slots - valid_pairs(driver))
