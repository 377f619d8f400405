"""The decode kernels' widths on the CPU: the host plans at every imnet_gf
the kernels are compiled for, the padding that runs every other width, and
the plain versions of K1-K4 and K6 against the JAX package at the widths
other tests do not cover.

The kernels are compiled for the decoder widths 4g-2g-g-1 of imnet_gf g in
``ops/decode_common.py::DECODER_GF`` (8, 16, 32, 64, 128), as the Pallas
kernels read theirs from their operands; any g from 1 to 128 runs at the
next compiled width, and a voxel width (pnet_out) at the next multiple of
16, with zero units and zero columns, the operands padded once where they
are made: the padded plain decode is held to the unpadded one here,
outputs and gradients. The plans are held at the widths of
``configs/smoke_synthetic.yaml`` (pnet_out 64, rgb_out 16, imnet_gf 32) and
of the tiny CLI model (pnet_out 16, rgb_out 8, imnet_gf 8), and at the
default model's; a width past the limits is refused with a message that
names the limit. The plain decodes run against ``xla_ray_decode``, the JAX
kernels in interpret mode, ``xla_ief_rows`` and ``xla_pair_decode`` at
imnet_gf 32 and 8 (test_torch_port_ops.py holds K1 and K4 at 16,
test_torch_port_train.py K2 and K3 at 8, test_torch_port_pair_decode.py K6
at 8). The reference's model options W1-W6 (imnet_gf 48 and 128, rgb_out
64, roi_out_bbox 4, pnet_out 100, pnet_out 512 with multires 10) and W7
(all of them at their extreme at once) run the stage-1 and stage-2 steps
and the eval forward against the JAX package's (section (f)), both sides
in float32 (``tpu.compute_dtype``), JAX under ``jax.jit`` with
``tpu.use_pallas_decode: false``. The kernels themselves run on the card
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
from implicit_depth_torch.ops import decode_common as common
from implicit_depth_torch.ops import ief_decode as ied
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
# (voxel width as the kernels see it, roi features, multires) of those
# models and of the reference's width options at the default model (W1 and
# W2 set imnet_gf alone, which the plan tests vary; W5's pnet_out 100 runs
# at 112; W7 every option at its extreme at once: pnet_out 512, rgb_out 64,
# roi_out_bbox 4, multires 10)
LAYER1 = {**{k: (v[0], 4 * v[1], MULTIRES) for k, v in MODELS.items()},
          "W3": (128, 256, 8), "W4": (128, 512, 8), "W5": (112, 128, 8),
          "W6": (512, 128, 10), "W7": (512, 1024, 10)}


def T(a):
    return torch.from_numpy(np.array(a))


def N(t):
    return t.detach().float().numpy()


def _round16(x):
    return -(-x // 16) * 16


def _layer1_widths(pnet_out, c_roi, multires=MULTIRES):
    """(kp, crp) of K1/K2/K3, kp of K4 (refine pnet_out = pnet_out, the
    refine model's multires 8) and of K6, for a model's widths."""
    return {"K1": (_round16(pnet_out + 6 + 12 * multires),
                   _round16(c_roi + C_DIR)),
            "K4": (_round16(pnet_out + c_roi + C_DIR + posenc_dim(MULTIRES)),
                   0),
            "K6": (pd.pair_layout(pnet_out, c_roi, C_DIR, multires)["kp"], 0)}


# -- (c) the host plans at every width -----------------------------------------

@pytest.mark.parametrize("g", common.DECODER_GF)
@pytest.mark.parametrize("model", list(LAYER1))
@pytest.mark.parametrize("kernel", ["K1", "K2all", "K4", "K6"])
def test_forward_plans_fit_at_every_width(kernel, model, g):
    """Every forward decode's bf16 and f32 block at each imnet_gf with the
    model's layer-1 widths: the shared memory fits, the schedule holds its
    products, every product's slab fits the ring and divides into 16-deep
    mma steps, the warp grid covers the product with at most 8 warps (at
    most 4 along N in a tile), and the wrapper's check accepts it. f32 at
    imnet_gf 128 (and K4's and K6's widest rows) takes blocks of 16 rows;
    bf16 at the widest inputs the chunked layout. K1's libraries hold
    those two only at imnet_gf 128: below it the single layout and 32 f32
    rows hold every width the wrappers take (ray_decode.cu::run)."""
    kp, crp = _layer1_widths(*LAYER1[model])["K1" if kernel == "K2all"
                                             else kernel]
    assert kp <= common.MAX_KP[kernel] and crp <= common.MAX_CRP
    for bf16 in (True, False):
        plan = common.check_plan("test", kernel, kp, crp, 2, bf16, 80000, g)
        smem = plan["smem"]
        assert smem["total"] <= common.MAX_SMEM
        assert all(o % 128 == 0 for o in smem.values())
        rows = plan["rows_per_tile"]
        if kernel in ("K1", "K2all") and g < 128:
            assert plan["layout"] != "chunked" and rows in (64, 32)
        if plan["layout"] == "chunked":
            ks = common.slab_rows(4 * g)
            assert plan["chunk"] % ks == 0 and 0 < plan["chunk"] < kp
            assert smem["x1"] == smem["x0"]
        if not bf16 and rows == 16:
            assert common.decode_plan(kernel, kp, crp, is_bf16=False, g=g,
                                      n=1)["smem"]["total"] <= common.MAX_SMEM
            assert common.f32_layout(kernel, 32, kp, crp, g)["total"] \
                > common.MAX_SMEM
    plan = common.decode_plan(kernel, kp, crp, g=g, n=80000)
    assert len(plan["schedule"]) <= common.MAX_SEGS
    assert plan["slabs_per_tile"] >= common.RING
    g1, g2, g3 = 4 * g, 2 * g, g
    widths = [n for *_, n, _ in plan["schedule"]]
    assert set(widths) <= {2 * g1, g1, g2, g3}
    for (op, _, k, n, ks), grid in zip(plan["schedule"],
                                       plan["warp_grid"]):
        assert k % 16 == 0 and n % 8 == 0, op
        assert (n // 8) & (n // 8 - 1) == 0 and n // 8 <= 256, op
        assert ks == common.slab_rows(n) and ks % 16 == 0
        assert ks * (n + common.TILE_PAD) <= common.SLAB_ELEMS
        rows = 16 if op == "ray_w1" else common.TILE_ROWS
        assert grid["wn"] * grid["nt"] * 8 == n, op
        assert grid["wm"] * grid["mt"] * 16 == rows, op
        assert 1 <= grid["active"] <= common.WARPS, op
        assert grid["wn"] <= (common.WARPS if rows == 16
                              else common.WARPS_N), op


@pytest.mark.parametrize("g", common.DECODER_GF)
def test_narrow_products_leave_warps_without_a_tile(g):
    """The layer-3 product of a tile is g wide: at g 64 the 2 x 4 grid of
    the first kernels, narrower a grid with fewer warps along N, and at
    g 8 (one n8 tile) four warps own the tile's four m16 rows and four own
    nothing."""
    grid = common.warp_grid(common.TILE_ROWS, g)
    want = {128: (4, 2, 2, 4, 8), 64: (4, 2, 2, 2, 8), 32: (4, 2, 2, 1, 8),
            16: (2, 4, 1, 1, 8), 8: (1, 4, 1, 1, 4)}[g]
    assert (grid["wn"], grid["wm"], grid["mt"], grid["nt"],
            grid["active"]) == want
    assert common.warp_grid(common.TILE_ROWS, 256) == {
        "wn": 4, "wm": 2, "mt": 2, "nt": 8, "active": 8}
    # K1's per-ray product (16 rows, 2 x 4g wide): all 8 warps along N
    assert common.warp_grid(16, 8 * g) == {"wn": 8, "wm": 1, "mt": 1,
                                           "nt": g // 8, "active": 8}


@pytest.mark.parametrize("g", common.DECODER_GF)
@pytest.mark.parametrize("model", ["smoke_synthetic", "tiny CLI", "W7"])
def test_schedule_streams_each_weight_at_every_width(model, g):
    """The ring emulation of test_torch_port_decode_plan.py at each width:
    each product's slabs, cut by the plan alone, reassemble its operand's
    column block, and the product summed slab by slab is the whole
    product."""
    rng = np.random.default_rng(g)
    kp, crp = _layer1_widths(*LAYER1[model])["K1"]
    g1, g2, g3 = 4 * g, 2 * g, g
    ops = {"pair_w1": rng.normal(size=(kp, 2 * g1)),
           "ray_w1": rng.normal(size=(crp, 2 * g1))}
    for p in ("off_", "prob_"):
        ops[f"{p}w2"] = rng.normal(size=(g1, g2))
        ops[f"{p}w3"] = rng.normal(size=(g2, g3))
    used = []
    sched = common.decode_plan("K1", kp, crp, g=g)["schedule"]
    for op, col, k, n, ks in sched:
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


@pytest.mark.parametrize("g", common.DECODER_GF)
@pytest.mark.parametrize("model", ["smoke_synthetic", "tiny CLI", "W7"])
def test_k3_plan_at_every_width(model, g):
    """K3's plan at each width: the streams carry the decoder's widths, the
    reductions write every element of the gradients' output once, and the
    emulated Pass B (tiles of K3_TILE, a narrow gradient in part of one
    tile column) reproduces each weight gradient exactly. At W7 (kp 640,
    crp 1056) Pass A's block fits in both types (16 rows where 32 do
    not)."""
    pnet_out, c_roi, multires = LAYER1[model]
    kp, crp = _layer1_widths(pnet_out, c_roi, multires)["K1"]
    assert kp <= common.MAX_KP["K3"]
    n, n_iter = 37, 2
    for bf16 in (True, False):
        p = rd.bwd_plan(n, kp, crp, n_iter, bf16, 5, 16, 24,
                        table_elems=30 * pnet_out, g=g, c_vox=pnet_out)
        m = p["rows_per_tile"]
        assert rd.bwd_held(m, g, bf16) and rd.bwd_smem(
            m, g, crp, n_iter, p["small_size"], bf16) <= common.MAX_SMEM
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


REFUSAL_CASES = ["gf 24", "gf 48", "gf 128", "gf 136", "not 4g-2g-g",
                 "kp past 640", "crp past 544", "K4/K6 kp past 944",
                 "c_vox past 512", "128 at the widest kp",
                 "compiled widths", "crp past 1056", "K4/K6 kp past 1696"]


@pytest.mark.parametrize("case", REFUSAL_CASES)
def test_a_width_outside_the_set_is_refused(case):
    """imnet_gf 24, 48 and 128 run (24 and 48 at the next compiled width);
    136, and layer-1 widths past the kernels' limits, are refused with a
    message that names the limit. The widths the parent refused past its
    limits (crp 544, K4's and K6's rows 944) and imnet_gf 128 at the
    widest inputs, f32 included, now run: every block fits up to the
    limits."""
    if case.startswith("gf "):
        g = int(case[3:])
        if g > common.MAX_GF:
            for f in (lambda: common.compiled_gf(g), lambda: common.decoder_gf(
                    "test", 4 * g, (4 * g, 2 * g), (2 * g, g))):
                with pytest.raises(ValueError, match="imnet_gf g? ?.*1 to 128"):
                    f()
            with pytest.raises(ValueError, match=r"in \(8, 16, 32, 64, 128\)"):
                common.check_plan("test", "K1", 176, 96, 2, True, 100, g)
            return
        assert common.decoder_gf("t", 4 * g, (4 * g, 2 * g), (2 * g, g)) == g
        G = common.compiled_gf(g)
        assert G == {24: 32, 48: 64, 128: 128}[g]
        common.check_plan("test", "K1", 240, 160, 2, True, 100, G)
        common.check_plan("test", "K6", 400, 0, 2, True, 100, G)
        common.check_plan("test", "K4", 336, 0, 2, True, 100, G)
        plan = rd.bwd_plan(100, 240, 160, 2, True, 132, g=G, c_vox=128)
        assert plan["rows_per_tile"] == (64 if G <= 64 else 32)
    elif case == "not 4g-2g-g":
        with pytest.raises(ValueError, match="got 128-64-16-1"):
            common.decoder_gf("test", 128, (128, 64), (64, 16))
    elif case == "kp past 640":
        for k in ("K1", "K2all"):
            common.check_plan("test", k, 640, 160, 2, True, 100)
            with pytest.raises(ValueError, match="kp up to 640"):
                common.check_plan("test", k, 656, 160, 2, True, 100)
        rd.bwd_plan(100, 640, 160, 2, True, 132, c_vox=512)
        with pytest.raises(ValueError, match="kp up to 640"):
            rd.bwd_plan(100, 656, 160, 2, True, 132, c_vox=512)
    elif case == "crp past 544":
        common.check_plan("test", "K1", 240, 544, 2, True, 100)
        common.check_plan("test", "K1", 240, 560, 2, True, 100)
        # K3's 64-row (wgmma) block holds these per-ray widths too
        assert rd.bwd_plan(100, 240, 544, 2, True, 132)["rows_per_tile"] == 64
        assert rd.bwd_plan(100, 240, 560, 2, True, 132)["rows_per_tile"] == 64
    elif case == "crp past 1056":
        common.check_plan("test", "K1", 640, 1056, 2, True, 100, 128)
        with pytest.raises(ValueError, match="crp up to 1056"):
            common.check_plan("test", "K1", 240, 1072, 2, True, 100)
        with pytest.raises(ValueError, match="crp up to 1056"):
            rd.bwd_plan(100, 240, 1072, 2, True, 132)
    elif case == "K4/K6 kp past 944":
        for k in ("K4", "K6"):
            common.check_plan("test", k, 944, 0, 2, True, 100)
            common.check_plan("test", k, 960, 0, 2, True, 100)
    elif case == "K4/K6 kp past 1696":
        for k in ("K4", "K6"):
            for bf16 in (True, False):
                common.check_plan("test", k, 1696, 0, 2, bf16, 100, 128)
            with pytest.raises(ValueError, match="kp up to 1696"):
                common.check_plan("test", k, 1712, 0, 2, True, 100)
    elif case == "c_vox past 512":
        with pytest.raises(ValueError, match="c_vox up to 512"):
            rd.bwd_plan(100, 640, 160, 2, True, 132, c_vox=520)
    elif case == "128 at the widest kp":
        # the layer-1 widths whose block the parent could not fit at
        # imnet_gf 128: X in chunks (bf16), 16-row blocks (f32)
        for bf16 in (True, False):
            k1 = common.check_plan("test", "K1", 640, 160, 2, bf16, 100, 128)
            k6 = common.check_plan("test", "K6", 944, 0, 2, bf16, 100, 128)
            assert (k1["layout"], k6["layout"]) == (
                ("chunked", "chunked") if bf16 else ("f32", "f32"))
            assert bf16 or k1["rows_per_tile"] == k6["rows_per_tile"] == 16
            assert rd.bwd_plan(100, 240, 160, 2, bf16, 132, g=128)[
                "rows_per_tile"] == (32 if bf16 else 16)
    else:
        assert [common.decoder_gf("t", 4 * g, (4 * g, 2 * g), (2 * g, g))
                for g in common.DECODER_GF] == list(common.DECODER_GF)
        assert [common.compiled_gf(g) for g in range(1, 129)] == \
            [min(c for c in common.DECODER_GF if c >= g)
             for g in range(1, 129)]


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
    pw = ied.prep_ief_weights({k: T(v) for k, v in w.items()}, c_end, c_rc,
                              c_pos, C_DIR, tdt)
    got = ied.ief_decode(T(end).to(tdt), T(rc).to(tdt), T(pe).to(tdt), pw)
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
                            common.cast_operands(w32, rd.FORMAT, tdt))
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


# -- (e) padding to the compiled widths: exact on the plain decodes ----------

# (imnet_gf, voxel width) of the padded cases: W1's 48 (run at 64) with
# W5's pnet_out 100 (at 112); 5 (at 8) with 16; a compiled imnet_gf with
# only the voxel width padded
PADDED = [(48, 100), (5, 16), (32, 20)]


def _assert_padded_exact(got, ref, what):
    """A padded decode against the unpadded one: the same values up to f32
    summation order (the padded products add exact zeros, which the CPU's
    matrix products may group differently): 1e-6 of the largest value."""
    got, ref = N(got), N(ref)
    assert got.shape == ref.shape, what
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-6 * max(np.abs(ref).max(), 1e-6),
                               err_msg=what)


def _pad_rest_zero(padded, cut):
    """Every element of the padded gradient outside the slice ``cut`` kept
    is 0: the slicing drops no gradient."""
    rest = padded.clone()
    rest[cut] = 0
    assert not rest.any()


def _leaves(rng, shapes):
    return [T(rng.normal(size=sh).astype(np.float32)).requires_grad_()
            for sh in shapes]


def _grads(out, cot, leaves):
    return torch.autograd.grad(out, leaves, cot, retain_graph=True)


def _padded_k1(g, cv, monkeypatch):
    """K1/K2/K3 (``rd.FORMAT``): the plain decode's outputs at the padded
    operands are the unpadded decode's, K2's saves are the unpadded saves
    with zero columns past the decoders' widths (what K3 reads), and in
    every ``decode_bwd`` mode the training Function (``RayDecodeTrain``;
    on the CPU its wrappers run their plain versions, K3 replaced by
    ``ray_decode_bwd_plain`` from the same saves) at the padded operands
    lays on the parameters, the table and the ray features the unpadded
    decode's gradients: autograd drops the pads'."""
    rng = np.random.default_rng(g + cv)
    c_roi, n, kb, cells_n = 32, 24, 8, 30
    w = {k: T(v).requires_grad_()
         for k, v in _decoders(rng, cv, c_roi, 4 * g, inside=True).items()}
    table, ray_feat = _leaves(rng, [(cells_n, cv), (n, c_roi + C_DIR)])
    cells = T(rng.integers(0, cells_n, (n, kb)).astype(np.int32))
    pos = T((0.6 * rng.normal(size=(n, kb, 6))).astype(np.float32))
    cot = [T(rng.normal(size=(n, kb)).astype(np.float32)) for _ in range(2)]
    leaves = [table, ray_feat, *w.values()]
    f32 = torch.float32

    def split():
        return rd.split_ray_decode_weights(w, cv, c_roi, C_DIR, MULTIRES, f32)

    padded = common.pad_operands(split(), rd.FORMAT)
    G, cp = common.compiled_gf(g), -(-cv // 16) * 16
    assert padded["b1"].shape == (8 * G,) and padded["dims"][0] == cp
    assert padded["pair_w1"].shape[0] == \
        -(-(cp + 6 + 12 * MULTIRES) // 16) * 16
    ptable = common.pad_columns(table, cp)
    assert ptable.shape == (cells_n, cp)
    with torch.no_grad():
        for saves in (True, "all"):
            ref = rd.ray_decode_plain(table, cells, pos, ray_feat, split(),
                                      saves=saves)
            got = rd.ray_decode_plain(ptable, cells, pos, ray_feat, padded,
                                      saves=saves)
            for k in range(2):
                _assert_padded_exact(got[k], ref[k], f"output {k}")
            names = rd.save_names(2, "all" if saves == "all" else "l1")
            for name, s_got, s_ref in zip(names, got[2], ref[2]):
                _assert_padded_exact(s_got[:, :s_ref.shape[1]], s_ref, name)
                _pad_rest_zero(s_got, (slice(None),
                                       slice(0, s_ref.shape[1])))
        served = rd.prep_ray_decode_weights(
            {k: v.detach() for k, v in w.items()}, cv, c_roi, C_DIR,
            MULTIRES, torch.bfloat16)
        _assert_served_bits(rd.ray_decode, table, served,
                            (cells, pos, ray_feat))
    ref = rd.ray_decode_plain(table, cells, pos, ray_feat, split())
    want = _grads(ref, cot, leaves)
    monkeypatch.setattr(rd, "ray_decode_bwd", lambda *a, **kw: (
        rd.ray_decode_bwd_plain(*a[:5], *a[6:], dtype=f32, saved=a[5],
                                **kw)))
    for mode in rd.DECODE_BWD_MODES:
        w32 = common.pad_operands(split(), rd.FORMAT)
        out = rd.RayDecodeTrain.apply(
            (f32, w32["dims"], 2, 0.001, False, mode),
            common.pad_columns(table, w32["dims"][0]), cells, pos, ray_feat,
            *(w32[k] for k in rd.FORMAT.operands))
        for k in range(2):
            _assert_padded_exact(out[k], ref[k], f"{mode} output {k}")
        for name, gv, wv in zip(["d_table", "d_ray_feat", *w], _grads(
                out, cot, leaves), want):
            assert gv.shape == wv.shape, (mode, name)
            _assert_padded_exact(gv, wv, f"{mode} {name}")


def _padded_k4(g, cv, monkeypatch):
    """K4 (``ied.FORMAT``; c_end padded as the voxel width): the plain
    decode at the padded operands is the unpadded decode, and its training
    Function (``IefDecodeTrain``; the plain version on the CPU) lays the
    unpadded gradients on the parameters and inputs."""
    rng = np.random.default_rng(7 * g + cv)
    f32 = torch.float32
    c_rc, c_pos, n = 32 + C_DIR, posenc_dim(MULTIRES), 40
    w = {"enc_w": rng.normal(size=(1, 16)).astype(np.float32),
         "enc_b": (0.1 * rng.normal(size=(16,))).astype(np.float32)}
    _mlp_weights(rng, "", cv + c_rc + c_pos + 16, 4 * g, w, 0.25)
    w = {k: T(v).requires_grad_() for k, v in w.items()}
    end, rc, pe = _leaves(rng, [(n, cv), (n, c_rc), (n, c_pos)])
    cot = T(rng.normal(size=(n,)).astype(np.float32))
    leaves = [end, rc, pe, *w.values()]
    ops = ied.split_ief_weights(w, cv, c_rc, c_pos, C_DIR, f32)
    padded = common.pad_operands(ops, ied.FORMAT)
    assert padded["dims"][0] == -(-cv // 16) * 16
    assert padded["w1"].shape[1] == 4 * common.compiled_gf(g)
    pend = common.pad_columns(end, padded["dims"][0])
    ref = ied.ief_decode_plain(end, rc, pe, ops)
    _assert_padded_exact(ied.ief_decode_plain(pend, rc, pe, padded), ref,
                         "K4")
    with torch.no_grad():
        served = ied.prep_ief_weights({k: v.detach() for k, v in w.items()},
                                      cv, c_rc, c_pos, C_DIR, torch.bfloat16)
        _assert_served_bits(ied.ief_decode, end, served, (rc, pe))
    out = ied.IefDecodeTrain.apply((f32, padded["dims"], 2, 0.001, False),
                                   pend, rc, pe,
                                   *(padded[k] for k in ied.FORMAT.operands))
    _assert_padded_exact(out, ref, "K4 training")
    for gv, wv in zip(_grads(out, cot, leaves), _grads(ref, cot, leaves)):
        assert gv.shape == wv.shape
        _assert_padded_exact(gv, wv, "K4 gradient")


def _padded_k6(g, cv, monkeypatch):
    """K6 (``pd.FORMAT``): the plain decode at the padded operands is the
    unpadded decode, and its training Function (``PairDecodeTrain``; the
    plain version on the CPU) lays the unpadded gradients on the
    parameters and inputs."""
    rng = np.random.default_rng(11 * g + cv)
    f32 = torch.float32
    c_roi, p, n_rays, n_table = 32, 60, 20, 25
    w = {k: T(v).requires_grad_()
         for k, v in _decoders(rng, cv, c_roi, 4 * g, inside=True).items()}
    table, ray_feat = _leaves(rng, [(n_table, cv), (n_rays, c_roi + C_DIR)])
    cells = T(rng.integers(0, n_table, p).astype(np.int32))
    rays = T(rng.integers(0, n_rays, p).astype(np.int32))
    pos = T((0.6 * rng.normal(size=(p, 6))).astype(np.float32))
    cot = [T(rng.normal(size=(p,)).astype(np.float32)) for _ in range(2)]
    leaves = [table, ray_feat, *w.values()]
    ops = pd.pair_decode_weights(w, cv, c_roi, C_DIR, MULTIRES, f32)
    padded = common.pad_operands(ops, pd.FORMAT)
    assert padded["w1"].shape[0] == pd.pair_layout(
        -(-cv // 16) * 16, c_roi, C_DIR, MULTIRES)["kp"]
    ptable = common.pad_columns(table, padded["dims"][0])
    ref = pd.pair_decode_plain(table, cells, pos, ray_feat, ops, rays)
    got = pd.pair_decode_plain(ptable, cells, pos, ray_feat, padded, rays)
    for k in range(2):
        _assert_padded_exact(got[k], ref[k], f"K6 output {k}")
    with torch.no_grad():
        served = pd.prep_pair_decode_weights(
            {k: v.detach() for k, v in w.items()}, cv, c_roi, C_DIR,
            MULTIRES, torch.bfloat16)
        _assert_served_bits(pd.pair_decode, table, served,
                            (cells, pos, ray_feat), rays)
    out = pd.PairDecodeTrain.apply(
        (f32, padded["dims"], 2, 0.001, False), ptable, cells, pos, ray_feat,
        rays, None, *(padded[k] for k in pd.FORMAT.operands))
    for gv, wv in zip(_grads(out, cot, leaves), _grads(ref, cot, leaves)):
        assert gv.shape == wv.shape
        _assert_padded_exact(gv, wv, "K6 gradient")


def _assert_served_bits(entry, rows, w, rest, *more):
    """The serving ``entry`` given the unpadded f32 table (end rows)
    ``rows`` returns the bits it returns given them cast to the operands'
    dtype and padded to ``w["dims"][0]`` columns, as the models passed them
    before the entries padded their own."""
    rows = rows.detach()
    rest = tuple(t.detach() for t in rest)
    mat = next(v for v in w.values() if torch.is_tensor(v) and v.dim() == 2)
    cast = common.pad_columns(rows.to(mat.dtype), w["dims"][0])
    assert rows.dtype == torch.float32 and rows.shape[1] <= cast.shape[1]
    got = entry(rows, *rest, w, *more)
    want = entry(cast, *rest, w, *more)
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("g,cv", PADDED)
@pytest.mark.parametrize("family", ["K1", "K4", "K6"])
def test_padded_decode_is_the_unpadded_one(family, g, cv, monkeypatch):
    """Each family's operands padded once by the one pad
    (``decode_common.pad_operands`` with the family's ``FORMAT``), under
    autograd, as the serving operands and the card's training entries pad
    them, the table or end rows by ``pad_columns``: the plain decodes and
    the training Functions at the padded operands give the unpadded
    decodes' outputs and gradients. Each serving entry pads and casts its
    own table or end rows: given them unpadded in f32 it returns the bits
    it returns given them padded and cast."""
    {"K1": _padded_k1, "K4": _padded_k4, "K6": _padded_k6}[family](
        g, cv, monkeypatch)


@pytest.mark.parametrize("family", ["K1", "K4", "K6"])
def test_prep_is_the_cast_split(family):
    """Each family's serving operands (``prep_*``) are its training split
    at the kernels' widths (``pad_operands``), cast as the kernels take it
    (``cast_operands``), at widths that pad both the decoders and the
    voxel (end) width."""
    g, cv = PADDED[0]
    rng = np.random.default_rng(46)
    c_roi = 32
    if family == "K4":
        c_rc, c_pos = c_roi + C_DIR, posenc_dim(MULTIRES)
        w = {"enc_w": rng.normal(size=(1, 16)).astype(np.float32),
             "enc_b": (0.1 * rng.normal(size=(16,))).astype(np.float32)}
        _mlp_weights(rng, "", cv + c_rc + c_pos + 16, 4 * g, w)
        args, fmt = (cv, c_rc, c_pos, C_DIR), ied.FORMAT
        prep, split = ied.prep_ief_weights, ied.split_ief_weights
    else:
        w = _decoders(rng, cv, c_roi, 4 * g)
        args = (cv, c_roi, C_DIR, MULTIRES)
        mod = rd if family == "K1" else pd
        fmt = mod.FORMAT
        prep, split = {"K1": (rd.prep_ray_decode_weights,
                              rd.split_ray_decode_weights),
                       "K6": (pd.prep_pair_decode_weights,
                              pd.pair_decode_weights)}[family]
    tw = {k: T(v) for k, v in w.items()}
    for dt in (torch.float32, torch.bfloat16):
        served = prep(tw, *args, dt)
        f32 = split(tw, *args, dt)
        assert all(f32[k].dtype == torch.float32 for k in fmt.operands)
        cast = common.cast_operands(common.pad_operands(f32, fmt), fmt, dt)
        assert served["dims"] == cast["dims"]
        for k in fmt.operands:
            assert served[k].dtype == cast[k].dtype, k
            np.testing.assert_array_equal(N(served[k].float()),
                                          N(cast[k].float()), err_msg=k)


# -- (f) the reference's model options W1-W7 against the JAX package ---------

# W1-W7 on the tiny model (ResNet stages of one block, 48x64 frames, 512
# valid points, per_ray kb 8 of K 12; its other widths rgb_out 8, pnet_out
# 16, imnet_gf 8): the model and refine options each sets. Weights and
# batch from seed 45. At test_torch_port_options.py's seed 44 the W2-W4
# steps' gradients differed from JAX's by 2e-3-9e-3 of their largest
# values (the ResNet group's norm 2.0e-3 at W2, 2.7e-3 at W4, W4's offset
# decoder layer 1 9.0e-3), from the ResNet down; at seeds 45 and 46 every
# group of W2-W4 kept within 1.1e-5, as the default tiny model does at 44.
# At W2 the cause is shown (test_seed_44_puts_a_w2_relu_input_at_its_kink):
# a batch-normed ReLU input of layer 4 lies 5.7e-7 from 0, within the two
# frameworks' f32 difference, so each sends it another way. W3's and W4's
# nearest inputs at seed 44 are 1.4e-6 and 1.3e-6 from 0, no nearer than
# W2's at seed 46 (1.4e-6), which matched: their failure has the same
# signature but is not pinned to one element.
WIDTH_OPTIONS = {
    "W1": {"model": {"imnet_gf": 48}, "refine": {"imnet_gf": 48}},
    "W2": {"model": {"imnet_gf": 128}, "refine": {"imnet_gf": 128}},
    "W3": {"model": {"rgb_out": 64}},
    "W4": {"model": {"roi_out_bbox": 4}},
    "W5": {"model": {"pnet_out": 100}, "refine": {"pnet_out": 100}},
    "W6": {"model": {"pnet_out": 512, "multires": 10},
           "refine": {"pnet_out": 512}},
    # every option above at its extreme at once: kp 640, crp 1056, K4's
    # rows 1616, K6's 1696, decoders 512-256-128-1
    "W7": {"model": {"imnet_gf": 128, "pnet_out": 512, "multires": 10,
                     "rgb_out": 64, "roi_out_bbox": 4},
           "refine": {"imnet_gf": 128, "pnet_out": 512}},
}
_WIDTH_CASES = {}


def width_case(w):
    from test_torch_port_options import Case
    if w not in _WIDTH_CASES:
        _WIDTH_CASES[w] = Case(WIDTH_OPTIONS[w], "per_ray", seed=45)
    return _WIDTH_CASES[w]


@pytest.mark.parametrize("w", list(WIDTH_OPTIONS))
def test_width_option_stage1_step_and_eval_match_jax(w):
    """f32, epoch 10: the stage-1 train step's losses (1e-4 relative) and
    every gradient (1e-4 of its largest value, plus 1e-7) against
    ``jax.grad`` of JAX's loss, the models built at the option's widths on
    both sides; then the eval forward of every pixel: the slots exactly,
    the logits within 1e-4 of their largest value, the positions 1e-4 m
    (the tolerances of test_torch_port_options.py)."""
    from test_torch_port_options import H, W
    from test_torch_port_train import _jax_step, assert_rel_max

    from implicit_depth_tpu.builder import build_lidf as jax_build_lidf
    from implicit_depth_tpu.builder import build_static as jax_build_static
    from implicit_depth_tpu.models import lidf as jlidf
    from implicit_depth_torch.builder import build_lidf, build_static
    from implicit_depth_torch.models import lidf as port_lidf
    from implicit_depth_torch.train.state import TrainState
    from implicit_depth_torch.train.steps import make_lidf_train_step
    from implicit_depth_torch.weights import lidf_from_jax, lidf_grads_from_jax
    c = width_case(w)
    jin, jgrads, jlosses, _ = _jax_step(c.jcfg, c.jstatic, c.jlidf, c.lvars,
                                        c.raw, 10)
    model = c.port_models()[0]
    assert model.fused and model.decode_mode == "per_ray"
    state = TrainState.create(model, c.cfg.training, steps_per_epoch=10)
    losses = make_lidf_train_step(c.cfg, model, "cpu")(
        state, c.tbatch(), None, 10, valid_idx=T(jin["valid_idx"]),
        miss_start=T(jin["miss_start"]))
    for k in jlosses:
        np.testing.assert_allclose(N(losses[k]), np.asarray(jlosses[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    want = lidf_grads_from_jax(jgrads, model)
    for name, p in model.named_parameters():
        assert_rel_max(N(p.grad), N(want[name]), 1e-4, name, atol=1e-7)

    jstatic = jax_build_static(c.jcfg, n_rays=H * W)
    jmodel = jax_build_lidf(c.jcfg, jstatic)
    jin = jax.jit(lambda b, k: jlidf.prepare_inputs(
        jstatic, b, k, train=False))(c.batch, jax.random.key(3))
    jout = jax.jit(lambda v, i: jmodel.apply(v, i, train=False,
                                             use_gt_label=False))(
        c.lvars, jin)
    static = build_static(c.cfg, n_rays=H * W)
    model = lidf_from_jax(c.lvars, build_lidf(c.cfg, static)).eval()
    with torch.no_grad():
        inp = port_lidf.prepare_inputs(static, c.tbatch(),
                                       valid_idx=T(jin["valid_idx"]))
        out = model(inp)
    np.testing.assert_array_equal(N(out["max_slot"]),
                                  np.asarray(jout["max_slot"]))
    assert_rel_max(N(out["prob_logit"]), np.asarray(jout["prob_logit"]),
                   1e-4, "prob_logit")
    np.testing.assert_allclose(N(out["pred_pos"]),
                               np.asarray(jout["pred_pos"]), atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("w", list(WIDTH_OPTIONS))
def test_width_option_stage2_step_matches_jax(w):
    """f32, epoch 10: the refine step's losses within 1e-5 and every refine
    gradient within 1e-4 of its largest value (plus 1e-7) against JAX's, as
    test_torch_port_options.py holds the other options."""
    from test_torch_port_refine_train import _jax_refine_step
    from test_torch_port_train import assert_rel_max

    from implicit_depth_torch.train.state import TrainState
    from implicit_depth_torch.train.steps import make_refine_train_step
    from implicit_depth_torch.weights import refine_grads_from_jax
    c = width_case(w)
    jin, jgrads, jlosses, noise = _jax_refine_step(c, 10)
    lidf_m, ref = c.port_models()
    assert ref.fused
    state = TrainState.create(ref, c.cfg.training, steps_per_epoch=10)
    losses = make_refine_train_step(c.cfg, lidf_m, ref, "cpu")(
        state, c.tbatch(), None, 10, valid_idx=T(jin["valid_idx"]),
        miss_start=T(jin["miss_start"]),
        noise={k: T(v) for k, v in noise.items()})
    for k in jlosses:
        np.testing.assert_allclose(N(losses[k]), np.asarray(jlosses[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    want = refine_grads_from_jax(jgrads, ref)
    for name, p in ref.named_parameters():
        assert_rel_max(N(p.grad), N(want[name]), 1e-4, name, atol=1e-7)


# the nearest a ResNet ReLU input of a seed-45 width case lies to 0
# (W2-W4: 2.9e-6, 3.2e-6, 5.7e-6 in the train step's batch statistics)
# against W2's at seed 44 (5.7e-7)
KINK_NOISE = 1e-6


def _nearest_relu_input(model, rgb, monkeypatch):
    """The least |x| over every ReLU input of ``model``'s ResNet on
    ``rgb``, in train mode (the step's batch statistics)."""
    import torch.nn.functional as F

    from implicit_depth_torch.models import resnet
    seen = []

    def relu(x, *a, **kw):
        seen.append(x.detach().abs().min().item())
        return F.relu(x, *a, **kw)

    monkeypatch.setattr(resnet, "F", type("F", (), {
        **{k: staticmethod(v) for k, v in vars(F).items() if callable(v)},
        "relu": staticmethod(relu)}))
    with torch.no_grad():
        model.train().resnet(rgb, torch.float32)
    monkeypatch.undo()
    assert seen
    return min(seen)


def test_seed_44_puts_a_w2_relu_input_at_its_kink(monkeypatch):
    """Why section (f) runs at seed 45: at seed 44 the W2 model's ResNet
    puts a ReLU input within f32 noise of 0 (below KINK_NOISE), where the
    port and JAX, whose f32 sums differ by about that much, take the two
    sides of the kink; at seed 45 the W2-W4 models' nearest ReLU inputs
    lie at least twice KINK_NOISE from 0."""
    from test_torch_port_options import Case
    c = Case(WIDTH_OPTIONS["W2"], "per_ray", seed=44)
    assert _nearest_relu_input(c.port_models()[0], c.tbatch()["rgb"],
                               monkeypatch) < KINK_NOISE
    for w in ("W2", "W3", "W4"):
        c = width_case(w)
        assert _nearest_relu_input(c.port_models()[0], c.tbatch()["rgb"],
                                   monkeypatch) > 2 * KINK_NOISE, w
