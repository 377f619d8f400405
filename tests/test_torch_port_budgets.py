"""Every per-ray pair budget of the stage-1 decodes on the CPU: K1, K2 and
K3's plain versions against the JAX package's Pallas kernels at budgets
other than 8, the stage-1 model at those budgets against ``jax.grad``, and
the host plans of the kernels at every budget 1 <= kb <= 64.

The Pallas kernels take any budget kb (``fused_ray_decode`` tiles its rows
as ``rays_per_tile * kb``); the port's CUDA kernels take 1 <= kb <=
``ops/decode_common.py::MAX_KB`` and run only on the card
(``test_torch_port_cuda.py``, which holds them against these plain
versions). Here the JAX kernels run in interpret mode, as the JAX package's
own tests run them on the CPU, at imnet_gf 8 and c_vox 32, on 42 rays (2
images of 21, the JAX tiles 7 rays): the port's tiles of whole rays leave a
ragged last tile at every budget tested. Tolerances: those of
``test_torch_port_train.py``: f32 outputs and saves 1e-5 of their scale,
gradients 1e-4 of theirs; the whole train step's gradients 1e-4 of each
parameter's largest value (plus 1e-7 for sums that cancel).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from implicit_depth_tpu.builder import build_lidf as jax_build_lidf
from implicit_depth_tpu.builder import build_static as jax_build_static
from implicit_depth_tpu.config import load_config as jax_load_config
from implicit_depth_tpu.models import lidf as jlidf
from implicit_depth_tpu.ops.pallas_ray_decode import (
    _fused_fwd_impl,
    fused_ray_decode,
    fused_ray_decode_table,
    pack_pair_pos,
)
from implicit_depth_tpu.train import steps as jsteps
from implicit_depth_torch.builder import build_lidf, build_static
from implicit_depth_torch.config import load_config
from implicit_depth_torch.data.synthetic import synthetic_batch
from implicit_depth_torch.ops import decode_common as common
from implicit_depth_torch.ops import ray_decode as rd
from implicit_depth_torch.train.state import TrainState
from implicit_depth_torch.train.steps import make_lidf_train_step
from implicit_depth_torch.weights import lidf_from_jax, lidf_grads_from_jax

torch.set_num_threads(2)
# a first torch.sin before any JAX computation (see test_torch_port_ops.py)
torch.sin(torch.zeros(1 << 16))

BUDGETS = [1, 3, 4, 12, 16]
CV, C_ROI, C_DIR, GF4, MULTIRES = 32, 32, 27, 32, 8  # imnet_gf 8
N_IMG, RAYS_PER_IMG, CELLS, TILE = 2, 21, 40, 7
H, W = 48, 64


def T(a):
    return torch.from_numpy(np.array(a))


def N(t):
    return t.detach().float().numpy()


def assert_rel_max(got, ref, rtol, what="", atol=0.0):
    """|got - ref| <= rtol · max|ref| + atol (one algebra, another order)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref).max() if got.size else 0.0
    scale = np.abs(ref).max() if ref.size else 0.0
    assert err <= rtol * scale + atol, f"{what}: {err:.3g} > {rtol} x {scale:.3g}"


def _case(kb, seed):
    """The decoders' weights (JAX layout) and a batch of 42 rays of kb pair
    slots over 2 images' tables, from a seed."""
    rng = np.random.default_rng(seed)
    c_embed = CV + C_ROI + 6 * (1 + 2 * MULTIRES) + C_DIR
    w = {"off_enc_w": rng.normal(size=(1, 16)).astype(np.float32),
         "off_enc_b": (0.1 * rng.normal(size=(16,))).astype(np.float32)}
    for pre, ind in (("off_", c_embed + 16), ("prob_", c_embed)):
        dims = [(ind, GF4), (GF4, GF4 // 2), (GF4 // 2, GF4 // 4),
                (GF4 // 4, 1)]
        for i, (a, b) in enumerate(dims, 1):
            w[f"{pre}w{i}"] = (rng.normal(size=(a, b)) / np.sqrt(a)).astype(
                np.float32)
            w[f"{pre}b{i}"] = (0.1 * rng.normal(size=(b,))).astype(np.float32)
        # outputs inside (0, 1), away from the soft clamp's kinks
        w[f"{pre}w4"] *= 0.25
        w[f"{pre}b4"] = np.full((1,), 0.25 if pre == "off_" else 0.5,
                                np.float32)
    n = N_IMG * RAYS_PER_IMG
    local = rng.integers(0, CELLS, (n, kb)).astype(np.int32)
    img = np.arange(n)[:, None] // RAYS_PER_IMG
    return dict(
        w=w, local=local, cells=(local + img * CELLS).astype(np.int32),
        table=rng.normal(size=(N_IMG * CELLS, CV)).astype(np.float32),
        pos=(0.6 * rng.normal(size=(n, kb, 6))).astype(np.float32),
        ray_feat=rng.normal(size=(n, C_ROI + C_DIR)).astype(np.float32),
        g_off=rng.normal(size=(n, kb)).astype(np.float32),
        g_logit=rng.normal(size=(n, kb)).astype(np.float32))


def _jax(case):
    """JAX's (local cells, packed positions, ray features, table, weights)."""
    return (jnp.asarray(case["local"]),
            pack_pair_pos(jnp.asarray(case["pos"][..., :3]),
                          jnp.asarray(case["pos"][..., 3:])),
            jnp.asarray(case["ray_feat"]), jnp.asarray(case["table"]),
            {k: jnp.asarray(v) for k, v in case["w"].items()})


def _port(case, requires_grad=False):
    """The port's (table, cells, positions, ray features), its parameters
    and the f32 split operands made from them."""
    w = {k: T(v).requires_grad_(requires_grad) for k, v in case["w"].items()}
    w32 = rd.split_ray_decode_weights(w, CV, C_ROI, C_DIR, MULTIRES,
                                      torch.float32)
    return (T(case["table"]), T(case["cells"]), T(case["pos"]),
            T(case["ray_feat"])), w, w32


# -- the decode functions against the Pallas kernels ----------------------------

@pytest.mark.parametrize("kb", BUDGETS)
def test_ray_decode_plain_matches_fused_ray_decode(kb):
    """K1's function: ``fused_ray_decode`` on the gathered voxel rows
    against ``ray_decode_plain`` (the wrapper on the CPU), 1e-5."""
    case = _case(kb, 100 + kb)
    _, pos, rf, _, jw = _jax(case)
    pair_vox = jnp.asarray(case["table"][case["cells"].reshape(-1)])
    joff, jlogit = fused_ray_decode(pair_vox, pos, rf, jw, kb, MULTIRES, 2,
                                    0.001, False, jnp.float32, TILE, True)
    args, _, w32 = _port(case)
    off, logit = rd.ray_decode(*args, common.cast_operands(
        w32, rd.FORMAT, torch.float32))
    assert off.shape == (N_IMG * RAYS_PER_IMG, kb)
    assert_rel_max(N(off), np.asarray(joff), 1e-5, "offset")
    assert_rel_max(N(logit), np.asarray(jlogit), 1e-5, "logit")


@pytest.mark.parametrize("save_mode", ["l1", "all"])
@pytest.mark.parametrize("kb", BUDGETS)
def test_saving_forward_matches_fused_ray_decode_table(kb, save_mode):
    """K2's and K2 'all''s function: the training forward of
    ``fused_ray_decode_table`` (``_table_fwd``'s ``_fused_fwd_impl`` with
    ``save_mode``) against ``ray_decode_save`` / ``ray_decode_save_all``:
    the outputs and every save by name, 1e-5 of its scale."""
    case = _case(kb, 110 + kb)
    cells, pos, rf, table, jw = _jax(case)
    joff, jlogit, jsaves = _fused_fwd_impl(
        None, pos, rf, jw, kb, MULTIRES, 2, 0.001, False, jnp.float32, TILE,
        True, cell_ids=cells, vox_table=table,
        tiles_per_image=RAYS_PER_IMG // TILE, save_mode=save_mode,
        train=True)
    args, _, w32 = _port(case)
    fwd = rd.ray_decode_save if save_mode == "l1" else rd.ray_decode_save_all
    off, logit, saves = fwd(*args, common.cast_operands(
        w32, rd.FORMAT, torch.float32))
    names = rd.save_names(2, save_mode)
    assert len(names) == len(saves) == len(jsaves)
    assert_rel_max(N(off), np.asarray(joff), 1e-5, "offset")
    assert_rel_max(N(logit), np.asarray(jlogit), 1e-5, "logit")
    for name, got, want in zip(names, saves, jsaves):
        assert got.shape[0] == N_IMG * RAYS_PER_IMG * kb, name
        assert_rel_max(N(got), np.asarray(want, np.float32), 1e-5, name)


# each K3 instance: the JAX backward of that decode_bwd mode
# (_fused_bwd_impl from the l1 saves, from the full saves, recomputing)
BWD = {"kernel_save": "l1", "kernel_save_all": "all", "kernel": None}


@pytest.mark.parametrize("bwd_impl", list(BWD))
@pytest.mark.parametrize("kb", BUDGETS)
def test_ray_decode_bwd_plain_matches_fused_bwd(kb, bwd_impl):
    """K3's function: ``jax.vjp`` of ``fused_ray_decode_table`` with
    ``bwd_impl`` (``_fused_bwd_impl`` from the 'l1' saves, from the 'all'
    saves, or recomputing layer 1) against ``ray_decode_bwd_plain`` from
    the port's own saves of that kind (or none), the split operands'
    gradients laid back onto the parameters as training does: 1e-4 of each
    gradient's scale."""
    case = _case(kb, 120 + kb)
    cells, pos, rf, table, jw = _jax(case)

    def f(rf_, tb, ws):
        return fused_ray_decode_table(
            cells, pos, rf_, tb, ws, kb, RAYS_PER_IMG // TILE, MULTIRES, 2,
            0.001, False, jnp.float32, TILE, True, bwd_impl)

    _, vjp = jax.vjp(f, rf, table, jw)
    jd_rf, jd_tab, jd_w = vjp((jnp.asarray(case["g_off"]),
                               jnp.asarray(case["g_logit"])))
    args, wp, w32 = _port(case, requires_grad=True)
    w = common.cast_operands({k: v.detach() if torch.is_tensor(v)
                              else v for k, v in w32.items()}, rd.FORMAT,
                             torch.float32)
    saves = None
    if BWD[bwd_impl]:
        saves = rd.ray_decode_plain(*args, w, saves=BWD[bwd_impl])[2]
    d_tab, d_rf, d_split = rd.ray_decode_bwd_plain(
        *args, w, T(case["g_off"]), T(case["g_logit"]), dtype=torch.float32,
        saved=saves)
    torch.autograd.backward([w32[k] for k in rd.FORMAT.operands],
                            [d_split[k] for k in rd.FORMAT.operands])
    got = {"d_table": N(d_tab), "d_ray_feat": N(d_rf),
           **{k: N(v.grad) for k, v in wp.items()}}
    want = {"d_table": jd_tab, "d_ray_feat": jd_rf, **jd_w}
    # a decoder's last bias takes the sum of its N·kb cotangents, which
    # cancels: its f32 sums in two orders differ by ulps of the terms, up
    # to 2 ulps (2.4e-7) of the sum of their magnitudes
    floors = {"off_b4": np.abs(case["g_off"]).sum(),
              "prob_b4": np.abs(case["g_logit"]).sum()}
    for k, g in got.items():
        assert_rel_max(g, np.asarray(want[k], np.float32), 1e-4, k,
                       atol=2.4e-7 * floors.get(k, 0.0))


# -- the stage-1 model at budgets below the pair slots ------------------------

def _overrides(kb):
    """The tiny model of test_torch_port_train.py with K = 16 pair slots a
    ray and a per_ray budget of kb (< K): the fused per_ray decode in the
    port, the JAX package's XLA decode of the same slots."""
    return {
        "mask_type": "all",
        "dataset": {"img_height": H, "img_width": W},
        "model": {"rgb_out": 8, "pnet_out": 16, "pnet_gf": 8, "imnet_gf": 8,
                  "resnet_stages": [1, 1, 1, 1]},
        "grid": {"res": 8, "miss_sample_num": 256, "valid_sample_num": 512},
        "tpu": {"max_pairs_per_ray": 16, "pairs_budget_per_ray": kb,
                "use_pallas_decode": False, "compute_dtype": "float32"},
    }


def _randomize(tree, rng):
    """Every leaf redrawn at O(1) activation scale (as test_torch_port_train
    does), the decoders' outputs inside (0, 1)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize(v, rng)
            continue
        a = np.asarray(v)
        if k == "kernel":
            out[k] = (rng.normal(size=a.shape)
                      / np.sqrt(np.prod(a.shape[:-1]))).astype(np.float32)
        elif k == "scale":
            out[k] = (1.0 + 0.1 * rng.normal(size=a.shape)).astype(np.float32)
        elif k == "var":
            out[k] = (0.5 + 0.5 * np.abs(rng.normal(size=a.shape))).astype(
                np.float32)
        else:
            out[k] = (0.1 * rng.normal(size=a.shape)).astype(np.float32)
    return out


@pytest.mark.parametrize("kb", [4, 12])
def test_stage1_step_at_a_budget_matches_jax_grad(kb):
    """The stage-1 train step at ``pairs_budget_per_ray`` kb of K = 16
    slots (the port's per_ray decode through ``ray_decode_train``, on the
    CPU the plain decode under autograd) against ``jax.grad`` of the JAX
    ``loss_fn`` on the same batch and draws: the forward's per-slot outputs
    (kb logits a ray) and the predicted points, and every parameter's
    gradient within
    1e-4 of its largest value (plus 1e-7), f32."""
    ov = _overrides(kb)
    jcfg = jax_load_config(overrides=ov)
    jstatic = jax_build_static(jcfg)
    jmodel = jax_build_lidf(jcfg, jstatic)
    raw = synthetic_batch(40 + kb, 2, H, W)
    batch = {k: jnp.asarray(v) for k, v in raw.items()}
    jin = jax.jit(lambda b, k: jlidf.prepare_inputs(jstatic, b, k,
                                                    train=True))(
        batch, jax.random.key(2))
    var = jax.jit(lambda k, i: jmodel.init(k, i, train=False,
                                           use_gt_label=False))(
        jax.random.key(1), jin)
    var = _randomize(jax.device_get(var), np.random.default_rng(kb))
    for dec, bias in (("offset_dec", 0.5 / jcfg.model.n_iter),
                      ("prob_dec", 0.5)):
        last = var["params"][dec]["_MLP4_0"]["Dense_3"]
        last["kernel"] = last["kernel"] * 0.25
        last["bias"] = np.full_like(last["bias"], bias)
    epoch = 0  # the curriculum's labelled slot: no near-tie picks a slot

    def jstep(params, stats, b, key):
        inputs = jlidf.prepare_inputs(jstatic, b, key, train=True)

        def loss_fn(p):
            o, _ = jmodel.apply({"params": p, "batch_stats": stats}, inputs,
                                train=True, use_gt_label=True,
                                mutable=["batch_stats"])
            kw = jsteps._loss_kwargs(jcfg, True, epoch)
            kw["prob_w"] = jcfg.loss.prob_w
            return jlidf.lidf_loss(inputs, o, **kw)["loss_net"], o

        (_, out), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        return out, grads

    jout, jgrads = jax.jit(jstep)(var["params"], var["batch_stats"], batch,
                                  jax.random.key(2))
    assert np.asarray(jout["prob_logit"]).shape[-1] == kb
    cfg = load_config(overrides=ov)
    model = lidf_from_jax(var, build_lidf(cfg, build_static(cfg)))
    assert model.decode_mode == "per_ray" and model.fused
    state = TrainState.create(model, cfg.training, steps_per_epoch=10)
    captured = {}
    forward = model.forward

    def keep(*a, **kw):
        captured["out"] = out = forward(*a, **kw)
        return out

    model.forward = keep
    make_lidf_train_step(cfg, model, "cpu")(
        state, {k: T(v) for k, v in raw.items()}, None, epoch,
        valid_idx=T(jin["valid_idx"]), miss_start=T(jin["miss_start"]))
    out = captured["out"]
    for k in ("prob_logit", "pred_pos"):
        assert_rel_max(N(out[k]), np.asarray(jout[k]), 1e-5, k)
    want = lidf_grads_from_jax(jax.device_get(jgrads), model)
    for name, p in model.named_parameters():
        assert_rel_max(N(p.grad), N(want[name]), 1e-4, name, atol=1e-7)


# -- the kernels' host plans at every budget --------------------------------------

ALL_BUDGETS = list(range(1, common.MAX_KB + 1))
# layer-1 widths (kp, crp) of K1/K2/K3 at each imnet_gf tested: the tiny
# CLI model (pnet_out 16, rgb_out 8), configs/smoke_synthetic.yaml's
# (64, 16) and the default (128, 32), each with multires 8 and
# multires_views 4
WIDTHS = {8: (128, 64), 32: (176, 96), 64: (240, 160)}


def _covers_each_row_once(kb, rows, rays, n, tiles):
    """Each tile's rows (``tile_rows``) are the pair rows 0..n·kb-1, each
    once; a masked row maps to none."""
    seen = np.zeros(n * kb, np.int64)
    for t in range(tiles):
        got = common.tile_rows(kb, rows, rays, n, t)
        assert len(got) == rows
        live = [r for r in got if r is not None]
        # a tile's live rows come first and are consecutive pair rows
        assert got[:len(live)] == live
        assert live == list(range(live[0], live[0] + len(live))) if live \
            else True
        for r in live:
            seen[r] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("g", sorted(WIDTHS))
def test_forward_plans_at_every_budget(g):
    """K1 and K2 'all', bf16 and f32, at every kb from 1 to 64 and imnet_gf
    g: the tiles cover each of the n·kb pair rows exactly once and write
    no masked row (a ragged last tile; kb that does not divide the tile),
    the block fits the 227 KB of shared memory, and the wrapper's check
    accepts it; kb 65 raises, naming the limit."""
    kp, crp = WIDTHS[g]
    n = 37
    for kb in ALL_BUDGETS:
        for bf16 in (True, False):
            for kernel in ("K1", "K2all"):
                plan = common.check_plan("test", kernel, kp, crp, 2, bf16,
                                         n, g, kb)
                assert plan["smem"]["total"] <= common.MAX_SMEM
            rows, rays = plan["rows_per_tile"], plan["rays_per_tile"]
            cap = common.TC_RAYS if bf16 else common.F32_RAYS
            assert 1 <= rays <= cap and (rays * kb <= rows or rays == 1)
            if kb <= rows:  # whole rays, as many as the tile and cap allow
                assert rays == min(rows // kb, cap)
                assert plan["tiles_per_ray"] == 1
            else:           # f32 at kb > 32: a ray's slots over 2 blocks
                assert not bf16 and plan["tiles_per_ray"] == 2
            assert plan["tiles"] == -(-n // rays) * plan["tiles_per_ray"]
            _covers_each_row_once(kb, rows, rays, n, plan["tiles"])
    for bf16 in (True, False):
        with pytest.raises(ValueError, match="64"):
            common.decode_plan("K1", kp, crp, is_bf16=bf16, n=n, g=g, kb=65)


def test_forward_layout_does_not_depend_on_the_budget():
    """The shared memory of K1's block is the same at every kb (the per-ray
    regions hold 16 rays, one decoder's per-ray part at a time), so that
    the widest widths the wrappers accept fit at every kb; only the tiles
    change."""
    for g, (kp, crp) in [*WIDTHS.items(), (64, (common.MAX_KP["K1"],
                                                common.MAX_CRP))]:
        for bf16 in (True, False):
            at8 = common.decode_plan("K1", kp, crp, is_bf16=bf16, g=g)["smem"]
            for kb in ALL_BUDGETS:
                assert common.decode_plan("K1", kp, crp, is_bf16=bf16, g=g,
                                          kb=kb)["smem"] == at8
            assert at8["total"] <= common.MAX_SMEM


@pytest.mark.parametrize("g", sorted(WIDTHS))
def test_k3_plans_at_every_budget(g):
    """K3 at every kb from 1 to 64 and imnet_gf g, bf16 and f32: its tiles
    of whole rays cover each of a chunk's pair rows once and write no
    masked row; the chunks hold whole tiles of rays and cover the batch;
    the streams' pair rows are the chunk's rays times kb and the per-ray
    streams a row a ray and tile; the scratch is no larger than kb 8's at
    the same batch (the training batch 4 and 32, and a batch of one chunk)
    nor than kb 8's at its largest chunk; the packed plan carries kb; kb 65
    raises."""
    kp, crp = WIDTHS[g]
    table = 4 * 729 * 128
    for bf16 in (True, False):
        e = 2 if bf16 else 4
        most = rd.bwd_scratch_bytes(rd.bwd_plan(
            rd.K3_CHUNK_RAYS, kp, crp, 2, bf16, 132, table_elems=table, g=g),
            e)
        for n in (20000, 80000, 640000):
            at8 = rd.bwd_scratch_bytes(rd.bwd_plan(
                n, kp, crp, 2, bf16, 132, table_elems=table, g=g), e)
            for kb in ALL_BUDGETS:
                plan = rd.bwd_plan(n, kp, crp, 2, bf16, 132,
                                   table_elems=table, g=g, kb=kb)
                got = rd.bwd_scratch_bytes(plan, e)
                assert got <= at8 and got <= most, (kb, n, got, at8)
                m, rays = plan["rows_per_tile"], plan["rays_per_tile"]
                c = plan["chunk_rays"]
                assert rays == common.rays_per_tile(kb, m, m // 8)
                assert c % rays == 0 and c <= rd.K3_CHUNK_RAYS
                assert (plan["n_chunks"] - 1) * c < n <= plan["n_chunks"] * c
                tpr = plan["tiles_per_ray"]
                assert tpr == (2 if kb > m else 1)
                for name, (_, r, _, _) in plan["streams"].items():
                    per_ray = name in ("rf", "dre_off", "dre_prob")
                    assert r == (c * tpr if per_ray else c * kb), name
                packed = rd.pack_bwd_plan(plan)
                assert packed[37:40] == [kb, rays, tpr]
        # the tiles of 37 rays, chunk by chunk (a ragged last tile and
        # chunk): each pair row once
        for kb in ALL_BUDGETS:
            plan = rd.bwd_plan(37, kp, crp, 2, bf16, 132, g=g, kb=kb)
            m, rays = plan["rows_per_tile"], plan["rays_per_tile"]
            c, tpr = plan["chunk_rays"], plan["tiles_per_ray"]
            assert plan["tiles_per_chunk"] == -(-c // rays) * tpr
            seen = np.zeros(37 * kb, np.int64)
            for ci in range(plan["n_chunks"]):
                rays_c = min(c, 37 - ci * c)
                for t in range(-(-rays_c // rays) * tpr):
                    for r in common.tile_rows(kb, m, rays, rays_c, t):
                        if r is not None:
                            seen[ci * c * kb + r] += 1
            assert (seen == 1).all(), kb
        with pytest.raises(ValueError, match="64"):
            rd.bwd_plan(100, kp, crp, 2, bf16, 132, g=g, kb=65)


def test_budget_eight_plans_are_unchanged():
    """At kb 8 the plans are what the kernels had before any other budget:
    K1's tiles of 8 rays (4 in f32), K3's chunks of at most K3_CHUNK_RAYS
    rays in tiles of 8 (4), the 1.4 GB scratch of a full bf16 chunk."""
    k1 = common.decode_plan("K1", 240, 160, n=76800)
    assert (k1["rays_per_tile"], k1["tiles"]) == (8, 9600)
    f32 = common.decode_plan("K1", 240, 160, is_bf16=False, n=76800)
    assert (f32["rays_per_tile"], f32["tiles"]) == (4, 19200)
    one = rd.bwd_plan(rd.K3_CHUNK_RAYS, 240, 160, 2, True, 132)
    assert (one["rays_per_tile"], one["chunk_rays"], one["n_chunks"]) == \
        (8, rd.K3_CHUNK_RAYS, 1)
    assert 1.3e9 < rd.bwd_scratch_bytes(one, 2) < 1.5e9
    b4 = rd.bwd_plan(80000, 240, 160, 2, True, 132)
    assert (b4["chunk_rays"], b4["n_chunks"]) == (26672, 3)
