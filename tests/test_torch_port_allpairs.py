"""The ``global`` decode at a budget of every slot (the benchmark's
``lidf_allpairs_rn34_gf64``: every intersected pair decoded once) on the
CPU at a tiny size: against the benchmark's plain reference, which decodes
every slot and masks the invalid ones; no valid pair dropped; the spans
and counters of the pair decode; and the benchmark's counts of its work
(``benchmark/harness/pair_counts.py``) against hand-worked values."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from implicit_depth_torch.builder import build_static
from implicit_depth_torch.models import lidf as lidf_mod
from implicit_depth_torch.models.lidf import lidf_loss, prepare_inputs
from implicit_depth_torch.ops import pair_decode as pd
from implicit_depth_torch.ops import segment
from implicit_depth_torch.train.state import TrainState
from implicit_depth_torch.train.steps import _loss_kwargs, make_lidf_train_step
from implicit_depth_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness import (  # noqa: E402
    counts,
    flops,
    pair_counts,
    port,
    scenes,
    weights,
)
from benchmark.reference import geometry  # noqa: E402
from benchmark.reference import model as ref  # noqa: E402

torch.set_num_threads(2)
CONFIG = ROOT / "benchmark" / "configs" / "lidf_allpairs_rn34_gf64.json"
TRAFFIC = {"batch": 2, "height": 48, "width": 64, "pool": 1,
           "objects": [2, 4], "transparent": 2, "radius": [0.2, 0.35],
           "depth": [0.8, 1.6], "tilt": 0.2, "intrinsics_jitter": 0.05}


def _published():
    return json.loads(CONFIG.read_text())


def _tiny(k=20):
    """The configuration at a tiny size, float32, ``k`` slots a ray, all of
    them the budget."""
    cfg = _published()
    cfg["dataset"] = {"img_height": 48, "img_width": 64}
    cfg["model"].update(rgb_out=8, pnet_out=16, pnet_gf=8, imnet_gf=8)
    cfg["grid"].update(miss_sample_num=256, valid_sample_num=256)
    cfg["tpu"].update(compute_dtype="float32", max_pairs_per_ray=k,
                      pairs_budget_per_ray=k)
    return cfg


def _batch(seed):
    b = scenes.train_batch(np.random.default_rng(seed), TRAFFIC)
    return {k: torch.as_tensor(v) for k, v in b.items()}


def _program(cfg, seed, batch, gen_seed):
    """The program's stage-1 forward and loss in train mode (a step's,
    without the update) -> (loss, outputs, {leaf: gradient}, model)."""
    pcfg = port.config(cfg)
    static = build_static(pcfg)
    model, _ = port.models(cfg, pcfg, static,
                           port.make_weights(cfg, seed, "cpu"), "cpu")
    model.train()
    inputs = prepare_inputs(static, batch, train=True,
                            mask_type=pcfg.mask_type,
                            generator=torch.Generator().manual_seed(gen_seed))
    out = model(inputs, use_gt_label=False)
    loss = lidf_loss(inputs, out, **_loss_kwargs(pcfg, True, 10, "cpu"))
    loss = loss["loss_net"]
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    grads = torch.autograd.grad(loss, [dict(model.named_parameters())[n]
                                       for n in names], allow_unused=True)
    return loss, out, dict(zip(names, grads)), model, inputs


def _reference(cfg, seed, batch, gen_seed):
    c = {**cfg, "_grid": geometry.make_grid(cfg["grid"]["res"])}
    p = weights.split(port.make_weights(cfg, seed, "cpu"), "lidf.")
    names = ref.names_with_grad(ref.lidf_spec(c))
    for n in names:
        p[n] = p[n].clone().requires_grad_(True)
    inp = geometry.prepare(c["_grid"], batch, train=True,
                           n_valid=cfg["grid"]["valid_sample_num"],
                           n_rays=cfg["grid"]["miss_sample_num"],
                           k_pairs=cfg["tpu"]["max_pairs_per_ray"],
                           gen=torch.Generator().manual_seed(gen_seed))
    out = ref.lidf_forward(p, c, inp, train=True, use_gt=False,
                           prec=ref.Precision())
    loss = ref.lidf_loss(inp, out, cfg["loss"],
                         (cfg["dataset"]["img_height"],
                          cfg["dataset"]["img_width"]), 10)
    grads = torch.autograd.grad(loss, [p[n] for n in names])
    return loss, out, dict(zip(names, grads)), inp


@pytest.mark.parametrize("seed", [3, 2_000_000_011])
def test_global_at_every_slot_is_the_references_every_pair_math(seed):
    """The loss, the predicted points and every leaf's gradient of the
    program's ``global`` decode at a budget of K equal the plain
    reference's at kb = K (every slot decoded, the invalid ones masked out
    of the softmax, the argmax and the losses), in float32."""
    cfg = _tiny()
    batch = _batch(seed % 1000)
    loss, out, grads, model, _ = _program(cfg, seed, batch, seed)
    assert model.decode_mode == "global"
    rloss, rout, rgrads, _ = _reference(cfg, seed, batch, seed)
    assert float(loss.detach()) == pytest.approx(float(rloss.detach()),
                                                 rel=2e-5)
    torch.testing.assert_close(out["pred_pos"], rout["pred_pos"],
                               rtol=1e-4, atol=1e-5)
    assert torch.equal(out["pair_valid"], rout["pair_valid"])
    assert set(grads) == set(rgrads)
    med = float(np.median([float(g.norm()) for g in rgrads.values()]))
    for n, g in rgrads.items():
        got = grads[n] if grads[n] is not None else torch.zeros_like(g)
        err = float((got - g).norm()) / max(float(g.norm()), med)
        assert err < 2e-3, (n, err)


@pytest.mark.parametrize("seed", [5, 17])
def test_no_valid_pair_is_dropped_at_every_slot(seed):
    """At a budget of K the compacted rows are P = B·R·K, and the rows
    decoded (the valid prefix, counted on the device) are exactly the
    valid slots: every one of them decoded, in both outputs."""
    cfg = _tiny(k=12)
    pcfg = port.config(cfg)
    static = build_static(pcfg)
    model, _ = port.models(cfg, pcfg, static,
                           port.make_weights(cfg, seed, "cpu"), "cpu")
    model.train()
    inputs = prepare_inputs(static, _batch(seed), train=True,
                            mask_type=pcfg.mask_type,
                            generator=torch.Generator().manual_seed(seed))
    seen = {}
    real = model._decode_pairs

    def record(vox_feat, cells, pos, ray_feat, rays=None, n_rows=None):
        seen.update(rows=cells.shape[0], n_rows=int(n_rows))
        return real(vox_feat, cells, pos, ray_feat, rays, n_rows)

    model._decode_pairs = record
    with torch.no_grad():
        out = model(inputs)
    pv = inputs["pair_valid"]
    assert seen["rows"] == pv.numel()
    assert seen["n_rows"] == int(pv.sum()) > 0
    assert torch.equal(out["pair_valid"], pv)
    # a smaller budget under the same mode drops the farthest pairs
    model.pairs_budget = 1
    with torch.no_grad():
        out = model(inputs)
    assert seen["n_rows"] == min(int(pv.sum()), pv.shape[0] * pv.shape[1])
    assert int(out["pair_valid"].sum()) < int(pv.sum())


def test_the_pair_decodes_spans_and_counters(monkeypatch):
    """One ``global`` step through the card's training decode
    (``PairDecodeTrain``: the plain decode stands in for K6 on the CPU):
    ``lidf.compact_pairs`` under ``lidf.decode_rays``,
    ``pair_decode.forward`` under it, ``pair_decode.backward`` under
    ``train.backward`` with ``sync.pair_rows`` under it; the counters move
    by the rows recomputed and their chunks, and the segment sum's by the
    rows recomputed for each of the two tables (voxels and rays), with no
    kernel launch on the CPU."""
    cfg = _tiny()
    pcfg = port.config(cfg)
    static = build_static(pcfg)
    model, _ = port.models(cfg, pcfg, static,
                           port.make_weights(cfg, 7, "cpu"), "cpu")

    def train_decode(vox_table, cells, pos, ray_feat, w32, rays=None, *,
                     dtype, n_rows=None, n_iter=2, init_offset=0.001,
                     use_sigmoid=False):
        return pd.PairDecodeTrain.apply(
            (dtype, w32["dims"], n_iter, init_offset, use_sigmoid),
            vox_table, cells, pos, ray_feat, rays, n_rows,
            *(w32[k] for k in pd.FORMAT.operands))

    monkeypatch.setattr(lidf_mod, "pair_decode_train", train_decode)
    monkeypatch.setattr(pd, "TRAIN_CHUNK_ROWS", 100)
    step = make_lidf_train_step(pcfg, model, "cpu")
    state = TrainState.create(model, pcfg.training, steps_per_epoch=10)
    bwd = pd.pair_decode_bwd_chunked
    before = {k: getattr(bwd, k) for k in ("rows", "chunks")}
    summed = {k: getattr(segment.segment_sum_, k)
              for k in ("rows", "launches")}
    profiling.enable()
    try:
        since = max((r.id for r in profiling.spans()), default=0)
        step(state, _batch(7), torch.Generator().manual_seed(7), 0)
    finally:
        profiling.disable()
    recs = [r for r in profiling.spans() if r.id > since]
    by_id = {r.id: r for r in recs}
    parent = {r.name: by_id[r.parent].name for r in recs
              if r.parent in by_id and r.name.startswith(
                  ("lidf.compact", "pair_decode.", "sync.pair_rows"))}
    assert parent == {"lidf.compact_pairs": "lidf.decode_rays",
                      "pair_decode.forward": "lidf.decode_rays",
                      "pair_decode.backward": "train.backward",
                      "sync.pair_rows": "pair_decode.backward"}
    root = {r.root for r in recs}
    assert len(root) == 1 and by_id[root.pop()].name == "train.step"
    moved = {k: getattr(bwd, k) - v for k, v in before.items()}
    assert 0 < moved["rows"] <= 12_000
    assert moved["chunks"] == -(-moved["rows"] // 100)
    assert segment.segment_sum_.rows - summed["rows"] == 2 * moved["rows"]
    assert segment.segment_sum_.launches == summed["launches"]


def test_the_spans_and_counters_cost_nothing_off():
    """Off, the pair decode's spans are the one do-nothing context."""
    assert profiling.span("pair_decode.forward") is \
        profiling.span("sync.pair_rows")


# -- the benchmark's counts ------------------------------------------------------

def test_k6_bound_at_the_served_frame():
    """K6 at one 240×320 frame's ``global`` rows (280,001 decoded of
    614,400, the kernel table's B7 shapes), bf16: compute bound at 0.181
    ms."""
    cfg = _published()
    ops, nbytes = pair_counts.k6(cfg, 1, 76_800, 614_400, 280_001)
    g1, g2, g3 = 256, 128, 64
    tail = g1 * g2 + g2 * g3 + g3
    assert ops == 2 * 280_001 * ((128 + 128 + 6 * 17 + 27) * 2 * g1
                                 + 3 * tail)
    least = counts.least_seconds(ops, nbytes, "bfloat16")
    assert least == pytest.approx(ops / 989e12)
    assert least * 1e3 == pytest.approx(0.181, abs=5e-4)
    # the bytes: table, per-ray rows, weights, each row's cell, positions
    # and ray, every slot's two outputs
    w = 2 * 385 * g1 + 3 * tail
    assert nbytes == (729 * 128 + 76_800 * 155 + w) * 2 \
        + 280_001 * 32 + 614_400 * 8


@pytest.mark.parametrize("widths,hand", [
    # published: c_pair 230 (128 + 2·51), decoders 256-128-64-1
    ({}, 3 * (2 * 230 * 256 * 2 + 2 * 2 * 16 * 256 + 3 * 2 * 41_024
              + 2 * 16) + 2 * (2 * 16)),
    # tiny: c_pair 118 (16 + 2·51), decoders 32-16-8-1
    ({"pnet_out": 16, "imnet_gf": 8},
     3 * (2 * 118 * 32 * 2 + 2 * 2 * 16 * 32 + 3 * 2 * (32 * 16 + 16 * 8 + 8)
          + 2 * 16) + 2 * (2 * 16))])
def test_a_pair_slots_operations_by_hand(widths, hand):
    """One slot's products, forward and backward: both decoders' layer 1
    over the pair's columns, the IEF's offset code (1 -> 16) and its
    16 -> g1 product in each of 2 iterations, three tails; the backward
    twice each forward product, but the first iteration's offset code,
    whose input is a constant (its weight's gradient alone)."""
    cfg = _published()
    cfg["model"].update(widths)
    assert pair_counts.pair_train_flops(cfg) == hand


def test_an_allpairs_step_counts_the_valid_pairs_once():
    """The step's count is the reference's at every slot less the decode of
    each slot without a valid pair: at as many valid pairs as slots it is
    the whole step's, and each slot fewer takes one slot's decode off."""
    cfg = _tiny()

    class Drv:
        stage, epoch, t = "lidf", 0, {**TRAFFIC, "batch": 2}

        def decode_images_rays(self):
            return 2, cfg["grid"]["miss_sample_num"]

    d = Drv()
    d.cfg = cfg
    slots = 2 * 256 * 20
    d.pool_valid_pairs = slots
    whole = flops.train(cfg, d.t, "lidf", 0)
    assert pair_counts.allpairs_step_flops(d) == whole
    d.pool_valid_pairs = slots - 1000
    assert pair_counts.allpairs_step_flops(d) == \
        whole - 1000 * pair_counts.pair_train_flops(cfg)


def test_valid_pairs_are_the_references_pool_pairs():
    """The pool's valid pairs: the reference's geometry of each batch, the
    draws of the checked steps (one generator seeded by the run's seed)."""
    cfg = _tiny()
    pool = [scenes.train_batch(np.random.default_rng(s), TRAFFIC)
            for s in (1, 2)]

    class Drv:
        seed, dev = 99, torch.device("cpu")

    d = Drv()
    d.cfg, d.pool = cfg, pool
    gen = torch.Generator().manual_seed(99)
    want = []
    for hb in pool:
        inp = geometry.prepare(
            geometry.make_grid(8), {k: torch.as_tensor(v)
                                    for k, v in hb.items()},
            train=True, n_valid=256, n_rays=256, k_pairs=20, gen=gen)
        want.append(int(inp["pair_valid"].sum()))
    assert pair_counts.valid_pairs(d) == sum(want) / 2 > 0
