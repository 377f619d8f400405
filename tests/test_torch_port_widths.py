"""The decode kernels' widths on the CPU: the host plans at every imnet_gf
the kernels are compiled for, and the plain versions of K1-K4 and K6
against the JAX package at the widths other tests do not cover.

The kernels are compiled for the decoder widths 4g-2g-g-1 of imnet_gf g in
``ops/ray_decode.py::DECODER_GF`` (8, 16, 32, 64), as the Pallas kernels
read theirs from their operands. The plans are held at the widths of
``configs/smoke_synthetic.yaml`` (pnet_out 64, rgb_out 16, imnet_gf 32) and
of the tiny CLI model (pnet_out 16, rgb_out 8, imnet_gf 8), and at the
default model's; a width outside the set is refused with a message that
names it. The plain decodes run against ``xla_ray_decode``, the JAX
kernels in interpret mode, ``xla_ief_rows`` and ``xla_pair_decode`` at
imnet_gf 32 and 8 (test_torch_port_ops.py holds K1 and K4 at 16,
test_torch_port_train.py K2 and K3 at 8, test_torch_port_pair_decode.py K6
at 8). The kernels themselves run on the card
(``test_torch_port_cuda.py``).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from implicit_depth_tpu.ops.pallas_decode import xla_pair_decode
from implicit_depth_tpu.ops.pallas_ray_decode import (
    _fused_fwd_impl,
    fused_ray_decode_table,
    pack_pair_pos,
    xla_ief_rows,
    xla_ray_decode,
)
from implicit_depth_torch.models.embedder import posenc_dim
from implicit_depth_torch.ops import pair_decode as pd
from implicit_depth_torch.ops import ray_decode as rd

torch.set_num_threads(2)
# warm up the CPU sin before any XLA computation (see test_torch_port_ops.py)
torch.sin(torch.zeros(1 << 16))

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
# the tolerances of test_torch_port_ops.py and test_torch_port_train.py
ATOL = {"float32": 1e-5, "bfloat16": 2e-2}
NO_EXCESS = {"xla_allow_excess_precision": False}
MULTIRES, C_DIR = 8, posenc_dim(4)  # the configs' multires and _views

# (pnet_out, rgb_out, imnet_gf) of the models the configs and tests use
MODELS = {"smoke_synthetic": (64, 16, 32), "tiny CLI": (16, 8, 8),
          "default": (128, 32, 64)}


def T(a):
    return torch.from_numpy(np.array(a))


def N(t):
    return t.detach().float().numpy()


def _round16(x):
    return -(-x // 16) * 16


def _layer1_widths(pnet_out, rgb_out):
    """(kp, crp) of K1/K2/K3, kp of K4 (refine pnet_out = pnet_out) and of
    K6, for a model's widths."""
    c_roi = 4 * rgb_out
    return {"K1": (_round16(pnet_out + 6 + 12 * MULTIRES),
                   _round16(c_roi + C_DIR)),
            "K4": (_round16(pnet_out + c_roi + C_DIR + posenc_dim(MULTIRES)),
                   0),
            "K6": (pd.pair_layout(pnet_out, c_roi, C_DIR, MULTIRES)["kp"], 0)}


# -- (c) the host plans at every width -----------------------------------------

@pytest.mark.parametrize("g", rd.DECODER_GF)
@pytest.mark.parametrize("model", list(MODELS))
@pytest.mark.parametrize("kernel", ["K1", "K2all", "K4", "K6"])
def test_forward_plans_fit_at_every_width(kernel, model, g):
    """Every forward decode's bf16 and f32 block at each imnet_gf with the
    model's layer-1 widths: the shared memory fits, the schedule holds its
    products, every product's slab fits the ring and divides into 16-deep
    mma steps, the warp grid covers the product with at most 8 warps (at
    most 4 along N in a tile), and the wrapper's check accepts it."""
    pnet_out, rgb_out, _ = MODELS[model]
    kp, crp = _layer1_widths(pnet_out, rgb_out)["K1" if kernel == "K2all"
                                                 else kernel]
    for bf16 in (True, False):
        plan = rd._check_plan("test", kernel, kp, crp, 2, bf16, 80000, g)
        smem = plan["smem"]
        assert smem["total"] <= rd.MAX_SMEM
        assert all(o % 128 == 0 for o in smem.values())
    plan = rd.decode_plan(kernel, kp, crp, g=g, n=80000)
    assert len(plan["schedule"]) <= rd.MAX_SEGS
    assert plan["slabs_per_tile"] >= rd.RING
    g1, g2, g3 = 4 * g, 2 * g, g
    widths = [n for *_, n, _ in plan["schedule"]]
    assert set(widths) <= {2 * g1, g1, g2, g3}
    for (op, _, k, n, ks), grid in zip(plan["schedule"],
                                       plan["warp_grid"]):
        assert k % 16 == 0 and n % 8 == 0, op
        assert (n // 8) & (n // 8 - 1) == 0 and n // 8 <= 256, op
        assert ks == rd.slab_rows(n) and ks % 16 == 0
        assert ks * (n + rd.TILE_PAD) <= rd.SLAB_ELEMS
        rows = 16 if op == "ray_w1" else rd.TILE_ROWS
        assert grid["wn"] * grid["nt"] * 8 == n, op
        assert grid["wm"] * grid["mt"] * 16 == rows, op
        assert 1 <= grid["active"] <= rd.WARPS, op
        assert grid["wn"] <= (rd.WARPS if rows == 16 else rd.WARPS_N), op


@pytest.mark.parametrize("g", rd.DECODER_GF)
def test_narrow_products_leave_warps_without_a_tile(g):
    """The layer-3 product of a tile is g wide: at g 64 the 2 x 4 grid of
    the first kernels, narrower a grid with fewer warps along N, and at
    g 8 (one n8 tile) four warps own the tile's four m16 rows and four own
    nothing."""
    grid = rd.warp_grid(rd.TILE_ROWS, g)
    want = {64: (4, 2, 2, 2, 8), 32: (4, 2, 2, 1, 8), 16: (2, 4, 1, 1, 8),
            8: (1, 4, 1, 1, 4)}[g]
    assert (grid["wn"], grid["wm"], grid["mt"], grid["nt"],
            grid["active"]) == want
    assert rd.warp_grid(rd.TILE_ROWS, 256) == {"wn": 4, "wm": 2, "mt": 2,
                                               "nt": 8, "active": 8}
    # K1's per-ray product (16 rows, 2 x 4g wide): all 8 warps along N
    assert rd.warp_grid(16, 8 * g) == {"wn": 8, "wm": 1, "mt": 1,
                                       "nt": g // 8, "active": 8}


@pytest.mark.parametrize("g", rd.DECODER_GF)
@pytest.mark.parametrize("model", ["smoke_synthetic", "tiny CLI"])
def test_schedule_streams_each_weight_at_every_width(model, g):
    """The ring emulation of test_torch_port_decode_plan.py at each width:
    each product's slabs, cut by the plan alone, reassemble its operand's
    column block, and the product summed slab by slab is the whole
    product."""
    rng = np.random.default_rng(g)
    pnet_out, rgb_out, _ = MODELS[model]
    kp, crp = _layer1_widths(pnet_out, rgb_out)["K1"]
    g1, g2, g3 = 4 * g, 2 * g, g
    ops = {"pair_w1": rng.normal(size=(kp, 2 * g1)),
           "ray_w1": rng.normal(size=(crp, 2 * g1))}
    for p in ("off_", "prob_"):
        ops[f"{p}w2"] = rng.normal(size=(g1, g2))
        ops[f"{p}w3"] = rng.normal(size=(g2, g3))
    used = []
    for op, col, k, n, ks in rd.decode_plan("K1", kp, crp, g=g)["schedule"]:
        w = ops[op]
        slabs = [w[k0:min(k0 + ks, k), col:col + n] for k0 in range(0, k, ks)]
        np.testing.assert_array_equal(np.concatenate(slabs, 0),
                                      w[:k, col:col + n])
        a = rng.normal(size=(64, k))
        acc = sum(a[:, i * ks:i * ks + s.shape[0]] @ s
                  for i, s in enumerate(slabs))
        np.testing.assert_allclose(acc, a @ w[:k, col:col + n], rtol=1e-12,
                                   atol=1e-9)
        used.append((op, col, n))
    assert ("pair_w1", 0, g1) in used and ("pair_w1", g1, g1) in used
    # the per-ray part a decoder's half at a time
    assert ("ray_w1", 0, g1) in used and ("ray_w1", g1, g1) in used


def _emulate_k3(plan, n, n_iter, g, kp, crp, rng):
    """Pass B and the reductions of K3 from the plan alone (as
    test_torch_port_k3_plan.py emulates them), on integer streams: returns
    the output and each gradient's product over all rows."""
    lay = rd.bwd_grad_layout(kp, crp, g)
    partials = np.zeros(plan["partial_floats"])
    want = {k: np.zeros(shape) for k, (_, shape) in lay.items()
            if k != "total"}
    tk, tn = rd.K3_TILE
    c = plan["chunk_rays"]
    for ci in range(plan["n_chunks"]):
        rays_c = min(c, n - ci * c)
        streams = {}
        for name, (_, rows, width, inst) in plan["streams"].items():
            s = np.zeros((inst, rows, width))
            live = rays_c if rows == c else 8 * rays_c
            s[:, :live] = rng.integers(-3, 4, (inst, live, width))
            streams[name] = s
        for job in plan["jobs"]:
            a, b = streams[job["a"]], streams[job["b"]]
            rows = rays_c if job["a"] == "rf" else 8 * rays_c
            spi, ld = job["splits_per_inst"], job["tiles_n"] * tn
            stride = job["tiles_k"] * tk * ld
            for sp in range(job["n_inst"] * spi):
                inst = job["inst0"] + sp // spi
                r0 = (sp % spi) * plan["split_rows"]
                r1 = min(r0 + plan["split_rows"], rows)
                if r0 < r1:
                    prod = a[inst, r0:r1].T @ b[inst, r0:r1]
                    p = partials[job["p_off"] + sp * stride:
                                 job["p_off"] + (sp + 1) * stride]
                    p.reshape(-1, ld)[:prod.shape[0], :prod.shape[1]] += prod
        for grad, col, a, b, ief in rd.k3_jobs(g):
            for i in (range(1, n_iter + 1) if ief else range(1)):
                prod = streams[a][i].T @ streams[b][i]
                want[grad][:, col:col + prod.shape[1]] += prod
    out = np.zeros(lay["total"][0])
    for r in plan["reds"][:len(plan["jobs"])]:
        for i in range(r["k"]):
            src = r["src"] + i * r["ld_src"] + np.arange(r["n"])
            acc = sum(partials[src + t * r["stride"]]
                      for t in range(r["splits"]))
            out[r["dst"] + i * r["ld_dst"]:
                r["dst"] + i * r["ld_dst"] + r["n"]] += acc
    return out, want, lay


@pytest.mark.parametrize("g", rd.DECODER_GF)
@pytest.mark.parametrize("model", ["smoke_synthetic", "tiny CLI"])
def test_k3_plan_at_every_width(model, g):
    """K3's plan at each width: the streams carry the decoder's widths, the
    reductions write every element of the gradients' output once, and the
    emulated Pass B (tiles of K3_TILE, a narrow gradient in part of one
    tile column) reproduces each weight gradient exactly."""
    pnet_out, rgb_out, _ = MODELS[model]
    kp, crp = _layer1_widths(pnet_out, rgb_out)["K1"]
    assert kp <= rd.MAX_KP["K3"]
    n, n_iter = 37, 2
    plan = rd.bwd_plan(n, kp, crp, n_iter, True, 5, 16, 24,
                       table_elems=30 * pnet_out, g=g)
    widths = {"x": kp, "rf": crp, "dt2": 2 * g, "h2": 2 * g, "dt3": g}
    for name, (off, rows, width, inst) in plan["streams"].items():
        assert width == widths.get(name, 4 * g), name
        assert off % 64 == 0
    lay = rd.bwd_grad_layout(kp, crp, g)
    cover = np.zeros(lay["total"][0], int)
    for r in plan["reds"]:
        for i in range(r["k"]):
            cover[r["dst"] + i * r["ld_dst"]:
                  r["dst"] + i * r["ld_dst"] + r["n"]] += 1
    for k, (off, shape) in lay.items():
        if k != "total":
            assert (cover[off:off + math.prod(shape)] == 1).all(), k
    out, want, lay = _emulate_k3(plan, n, n_iter, g, kp, crp,
                                 np.random.default_rng(g))
    for grad in ("pair_w1", "ray_w1", "off_w2", "prob_w2", "off_w3",
                 "prob_w3"):
        off, shape = lay[grad]
        np.testing.assert_array_equal(
            out[off:off + math.prod(shape)].reshape(shape), want[grad], grad)


def test_a_width_outside_the_set_is_refused():
    """imnet_gf 24 and 128: the plans and the width check name the set the
    kernels are compiled for."""
    named = r"imnet_gf g in \(8, 16, 32, 64\)"
    for g in (24, 128):
        with pytest.raises(ValueError, match=named):
            rd._check_plan("test", "K1", 176, 96, 2, True, 100, g)
        with pytest.raises(ValueError, match=named):
            rd.bwd_plan(100, 176, 96, 2, True, 132, g=g)
        with pytest.raises(ValueError, match=named):
            rd.decoder_gf("test", 4 * g, (4 * g, 2 * g), (2 * g, g))
    # widths that are not 4g-2g-g: refused, naming what they are
    with pytest.raises(ValueError, match="got 128-64-16-1"):
        rd.decoder_gf("test", 128, (128, 64), (64, 16))
    assert [rd.decoder_gf("t", 4 * g, (4 * g, 2 * g), (2 * g, g))
            for g in rd.DECODER_GF] == list(rd.DECODER_GF)


# -- (d) the plain decodes against the JAX package at imnet_gf 32 and 8 -------

def _mlp_weights(rng, prefix, in_dim, gf4, w, last_scale=1.0):
    dims = [(in_dim, gf4), (gf4, gf4 // 2), (gf4 // 2, gf4 // 4),
            (gf4 // 4, 1)]
    for i, (a, b) in enumerate(dims, 1):
        w[f"{prefix}w{i}"] = (rng.normal(size=(a, b)) / np.sqrt(a)).astype(
            np.float32)
        w[f"{prefix}b{i}"] = (0.1 * rng.normal(size=(b,))).astype(np.float32)
    w[f"{prefix}w4"] *= last_scale


def _decoders(rng, cv, c_roi, gf4, inside=False):
    """Both stage-1 decoders in the JAX layout; ``inside``: outputs inside
    (0, 1), away from the soft clamp's kinks (for gradients)."""
    c_embed = cv + c_roi + 6 * (1 + 2 * MULTIRES) + C_DIR
    w = {"off_enc_w": rng.normal(size=(1, 16)).astype(np.float32),
         "off_enc_b": (0.1 * rng.normal(size=(16,))).astype(np.float32)}
    _mlp_weights(rng, "off_", c_embed + 16, gf4, w, 0.25 if inside else 1.0)
    _mlp_weights(rng, "prob_", c_embed, gf4, w, 0.25 if inside else 1.0)
    if inside:
        w["off_b4"] = np.full((1,), 0.25, np.float32)
        w["prob_b4"] = np.full((1,), 0.5, np.float32)
    return w


# (pnet_out, rgb_out) with each width: the smoke config's; the tiny model's
AT = {32: (64, 16), 8: (16, 8)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g", [32, 8])
def test_k1_plain_matches_xla_ray_decode(g, dtype):
    rng = np.random.default_rng(70 + g)
    cv, rgb_out = AT[g]
    c_roi, n, kb, cells_n = 4 * rgb_out, 64, 8, 50
    w = _decoders(rng, cv, c_roi, 4 * g)
    table = rng.normal(size=(cells_n, cv)).astype(np.float32)
    cells = rng.integers(0, cells_n, (n, kb)).astype(np.int32)
    pos = (0.6 * rng.normal(size=(n, kb, 6))).astype(np.float32)
    ray_feat = rng.normal(size=(n, c_roi + C_DIR)).astype(np.float32)
    tdt, jdt = DTYPES[dtype]
    ref = jax.jit(lambda pv, p, rf, ww: xla_ray_decode(
        pv.astype(jdt), p, rf.astype(jdt), ww, kb=kb, multires=MULTIRES,
        dtype=jdt))(table[cells.reshape(-1)], pos.reshape(-1, 6), ray_feat, w)
    pw = rd.prep_ray_decode_weights({k: T(v) for k, v in w.items()}, cv,
                                    c_roi, C_DIR, MULTIRES, tdt)
    got = rd.ray_decode(T(table).to(tdt), T(cells), T(pos),
                        T(ray_feat).to(tdt), pw)
    for gt, r in zip(got, ref):
        assert gt.shape == (n, kb)
        np.testing.assert_allclose(N(gt).reshape(-1), np.asarray(r),
                                   atol=ATOL[dtype], rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g", [32, 8])
def test_k4_plain_matches_xla_ief_rows(g, dtype):
    rng = np.random.default_rng(80 + g)
    c_end, rgb_out = AT[g]
    c_rc, c_pos, n = 4 * rgb_out + C_DIR, posenc_dim(MULTIRES), 96
    w = {"enc_w": rng.normal(size=(1, 16)).astype(np.float32),
         "enc_b": (0.1 * rng.normal(size=(16,))).astype(np.float32)}
    _mlp_weights(rng, "", c_end + c_rc + c_pos + 16, 4 * g, w)
    end = rng.normal(size=(n, c_end)).astype(np.float32)
    rc = rng.normal(size=(n, c_rc)).astype(np.float32)
    pe = rng.normal(size=(n, c_pos)).astype(np.float32)
    tdt, jdt = DTYPES[dtype]
    ref = jax.jit(lambda e, r, p, ww: xla_ief_rows(
        e.astype(jdt), r.astype(jdt), p.astype(jdt), ww, c_dir=C_DIR,
        dtype=jdt))(end, rc, pe, w)
    pw = rd.prep_ief_weights({k: T(v) for k, v in w.items()}, c_end, c_rc,
                             c_pos, C_DIR, tdt)
    got = rd.ief_decode(T(end).to(tdt), T(rc).to(tdt), T(pe).to(tdt), pw)
    assert got.shape == (n,)
    np.testing.assert_allclose(N(got), np.asarray(ref), atol=ATOL[dtype],
                               rtol=0)


# K6: f32 one algebra in another order; bf16 with excess precision off both
# sides round at the same places (test_torch_port_pair_decode.py PAIR_ATOL)
PAIR_ATOL = {"float32": 1e-5, "bfloat16": 1e-4}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k6_plain_matches_xla_pair_decode_at_32(dtype):
    rng = np.random.default_rng(90)
    cv, rgb_out = AT[32]
    c_roi, p, n_rays, n_table = 4 * rgb_out, 100, 40, 30
    w = _decoders(rng, cv, c_roi, 128, inside=True)
    table = rng.normal(size=(n_table, cv)).astype(np.float32)
    cells = rng.integers(0, n_table, p).astype(np.int32)
    rays = rng.integers(0, n_rays, p).astype(np.int32)
    pos = (0.6 * rng.normal(size=(p, 6))).astype(np.float32)
    ray_feat = rng.normal(size=(n_rays, c_roi + C_DIR)).astype(np.float32)
    tdt, jdt = DTYPES[dtype]
    rf = ray_feat[rays]
    args = (jnp.asarray(table[cells], jdt), jnp.asarray(rf[:, :c_roi], jdt),
            jnp.asarray(pos[:, :3]), jnp.asarray(pos[:, 3:]),
            jnp.asarray(rf[:, c_roi:], jdt),
            {k: jnp.asarray(v) for k, v in w.items()})
    f = jax.jit(lambda *a: xla_pair_decode(*a, multires=MULTIRES, dtype=jdt))
    ref = f.lower(*args).compile(compiler_options=NO_EXCESS)(*args)
    pw = pd.prep_pair_decode_weights({k: T(v) for k, v in w.items()}, cv,
                                     c_roi, C_DIR, MULTIRES, tdt)
    got = pd.pair_decode(T(table).to(tdt), T(cells), T(pos),
                         T(ray_feat).to(tdt), pw, T(rays))
    for gt, r in zip(got, ref):
        assert gt.shape == (p,)
        np.testing.assert_allclose(N(gt), np.asarray(r), atol=PAIR_ATOL[dtype],
                                   rtol=0)


# K2 and K3 at imnet_gf 32 (test_torch_port_train.py holds them at 8): two
# images of 32 rays, JAX's table kernels in interpret mode on tiles of 16
N_IMG, RAYS_PER_IMG, CELLS, TILE, KB = 2, 32, 40, 16, 8


def _table_case(seed):
    rng = np.random.default_rng(seed)
    cv, rgb_out = AT[32]
    c_roi = 4 * rgb_out
    n = N_IMG * RAYS_PER_IMG
    local = rng.integers(0, CELLS, (n, KB)).astype(np.int32)
    img = np.arange(n)[:, None] // RAYS_PER_IMG
    return dict(
        cv=cv, c_roi=c_roi, w=_decoders(rng, cv, c_roi, 128, inside=True),
        local=local, cells=(local + img * CELLS).astype(np.int32),
        table=rng.normal(size=(N_IMG * CELLS, cv)).astype(np.float32),
        pos=(0.6 * rng.normal(size=(n, KB, 6))).astype(np.float32),
        ray_feat=rng.normal(size=(n, c_roi + C_DIR)).astype(np.float32),
        g_off=rng.normal(size=(n, KB)).astype(np.float32),
        g_logit=rng.normal(size=(n, KB)).astype(np.float32))


def _jax_table_args(c, jdt):
    return (jnp.asarray(c["local"]),
            pack_pair_pos(jnp.asarray(c["pos"][..., :3]),
                          jnp.asarray(c["pos"][..., 3:])),
            jnp.asarray(c["ray_feat"], jdt), jnp.asarray(c["table"], jdt))


def _w32(c, dtype, requires_grad=False):
    w = {k: T(v).requires_grad_(requires_grad) for k, v in c["w"].items()}
    return w, rd.split_ray_decode_weights(w, c["cv"], c["c_roi"], C_DIR,
                                          MULTIRES, dtype)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-12), \
        np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-12)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["l1", "all"])
def test_k2_saves_match_the_jax_kernel_at_32(mode, dtype):
    """K2's function (``ray_decode_plain`` with saves, through the wrappers
    on the CPU) against ``_table_fwd``'s saves in interpret mode, by name:
    f32 1e-5 of each save's scale, bf16 a relative norm of 1e-2 (as at
    imnet_gf 8 in test_torch_port_train.py)."""
    c = _table_case(91)
    tdt, jdt = DTYPES[dtype]
    cells, pos, rf, table = _jax_table_args(c, jdt)
    joff, jlogit, jsaves = _fused_fwd_impl(
        None, pos, rf, {k: jnp.asarray(v) for k, v in c["w"].items()}, KB,
        MULTIRES, 2, 0.001, False, jdt, TILE, True, cell_ids=cells,
        vox_table=table, tiles_per_image=RAYS_PER_IMG // TILE,
        save_mode=mode, train=True)
    _, w32 = _w32(c, tdt)
    fwd = rd.ray_decode_save if mode == "l1" else rd.ray_decode_save_all
    off, logit, saves = fwd(T(c["table"]).to(tdt), T(c["cells"]),
                            T(c["pos"]), T(c["ray_feat"]).to(tdt),
                            rd.cast_ray_decode_operands(w32, tdt))
    names = rd.save_names(2, mode)
    assert len(saves) == len(jsaves) == len(names)
    for name, got, want in zip(("offset", "logit", *names),
                               (off, logit, *saves),
                               (joff, jlogit, *jsaves)):
        err_max, err_norm = _rel(N(got), np.asarray(want, np.float32))
        if dtype == "float32":
            assert err_max <= 1e-5, (name, err_max)
        else:
            assert err_norm <= 1e-2, (name, err_norm)


@pytest.mark.parametrize("dtype,bwd_impl", [
    ("float32", "kernel_save"), ("float32", "kernel_save_all"),
    ("float32", "kernel"), ("bfloat16", "xla")])
def test_k3_gradients_match_jax_at_32(dtype, bwd_impl):
    """The training decode's gradients (plain autograd on the CPU, K3's
    function) against ``jax.grad`` of ``fused_ray_decode_table`` with the
    same ``decode_bwd``, at the tolerances of test_torch_port_train.py: f32
    1e-4 of each gradient's scale, bf16 'xla' a relative norm of 2e-2."""
    c = _table_case(92)
    tdt, jdt = DTYPES[dtype]
    cells, pos, rf, table = _jax_table_args(c, jdt)

    def jloss(rf_, tb, ws):
        off, logit = fused_ray_decode_table(
            cells, pos, rf_, tb, ws, KB, RAYS_PER_IMG // TILE, MULTIRES, 2,
            0.001, False, jdt, TILE, True, bwd_impl)
        return jnp.sum(off * c["g_off"] + logit * c["g_logit"])

    jw = {k: jnp.asarray(v) for k, v in c["w"].items()}
    jd_rf, jd_tab, jd_w = jax.grad(jloss, argnums=(0, 1, 2))(rf, table, jw)
    w, w32 = _w32(c, tdt, requires_grad=True)
    tab = T(c["table"]).requires_grad_()
    ray_feat = T(c["ray_feat"]).to(tdt).requires_grad_()
    off, logit = rd.ray_decode_train(tab, T(c["cells"]), T(c["pos"]),
                                     ray_feat, w32, tdt, decode_bwd=bwd_impl)
    (off * T(c["g_off"]) + logit * T(c["g_logit"])).sum().backward()
    got = {"d_table": N(tab.grad), "d_ray_feat": N(ray_feat.grad),
           **{k: N(v.grad) for k, v in w.items()}}
    want = {"d_table": jd_tab, "d_ray_feat": jd_rf, **jd_w}
    for k, gv in got.items():
        err_max, err_norm = _rel(gv, np.asarray(want[k], np.float32))
        if dtype == "float32":
            assert err_max <= 1e-4, (k, err_max)
        else:
            assert err_norm <= 2e-2, (k, err_norm)
