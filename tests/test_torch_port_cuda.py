"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU (the kernels have no CPU mode) and skips
without one. The file imports no JAX, so it also runs on a machine that has
none; there, skip the JAX-importing conftest:

    python -m pytest --noconftest tests/test_torch_port_cuda.py -q
"""

import ctypes

import numpy as np
import pytest
import torch

from implicit_depth_torch.builder import (
    build_lidf,
    build_refine,
    build_static,
    randomize_weights_,
)
from implicit_depth_torch.config import load_config
from implicit_depth_torch.infer import DepthCompleter
from implicit_depth_torch.ops import cuda
from implicit_depth_torch.ops import decode_common as common
from implicit_depth_torch.ops import ief_decode as ied
from implicit_depth_torch.ops import pair_decode as pd
from implicit_depth_torch.ops import ray_decode as rd
from implicit_depth_torch.ops import segment

pytestmark = pytest.mark.cuda

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# f32: one algebra, another summation order; bf16: the summation order can
# move the bf16 rounding of a hidden activation by one ulp (~0.4% of ~1)
ATOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _mlp_weights(rng, prefix, in_dim, gf4, w):
    dims = [(in_dim, gf4), (gf4, gf4 // 2), (gf4 // 2, gf4 // 4), (gf4 // 4, 1)]
    for i, (a, b) in enumerate(dims, 1):
        w[f"{prefix}w{i}"] = rng.normal(size=(a, b)) / np.sqrt(a)
        w[f"{prefix}b{i}"] = 0.1 * rng.normal(size=(b,))


def _t(a, dev, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a)).to(dev, dtype)


def _close(got, ref, atol):
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert g.shape == r.shape and torch.isfinite(g).all()
        np.testing.assert_allclose(g.float().cpu().numpy(),
                                   r.float().cpu().numpy(), atol=atol, rtol=0)


# 100 rays: not a multiple of any kernel's rows per block (ragged last block)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ray_decode_kernel_matches_plain(dev, dtype):
    rng = np.random.default_rng(11)
    n, cv, c_roi, c_dir = 100, 128, 128, 27
    c_embed = cv + c_roi + 102 + c_dir
    w = {"off_enc_w": rng.normal(size=(1, 16)),
         "off_enc_b": 0.1 * rng.normal(size=(16,))}
    _mlp_weights(rng, "off_", c_embed + 16, 256, w)
    _mlp_weights(rng, "prob_", c_embed, 256, w)
    pw = rd.prep_ray_decode_weights({k: _t(v, dev) for k, v in w.items()},
                                    cv, c_roi, c_dir, 8, DTYPES[dtype])
    args = (_t(rng.normal(size=(30, cv)), dev, DTYPES[dtype]),
            _t(rng.integers(0, 30, (n, 8)), dev, torch.int32),
            _t(0.6 * rng.normal(size=(n, 8, 6)), dev),
            _t(rng.normal(size=(n, c_roi + c_dir)), dev, DTYPES[dtype]))
    before = rd.ray_decode.launches
    _close(rd.ray_decode(*args, pw), rd.ray_decode_plain(*args, pw), ATOL[dtype])
    assert rd.ray_decode.launches == before + 1


def _pair_case(rng, dev, dtype, p, n_rays, indexed, cv=128, c_roi=128,
               gf=64, multires=8):
    """K6's operands (the default widths unless given): P rows over
    ``n_rays`` rays (the dense layout when not ``indexed``: P / n_rays
    consecutive rows a ray)."""
    c_dir = 27
    c_embed = cv + c_roi + 6 * (1 + 2 * multires) + c_dir
    w = {"off_enc_w": rng.normal(size=(1, 16)),
         "off_enc_b": 0.1 * rng.normal(size=(16,))}
    _mlp_weights(rng, "off_", c_embed + 16, 4 * gf, w)
    _mlp_weights(rng, "prob_", c_embed, 4 * gf, w)
    for pre, bias in (("off_", 0.25), ("prob_", 0.5)):  # outputs in (0, 1)
        w[f"{pre}w4"] *= 0.25
        w[f"{pre}b4"] = np.full((1,), bias)
    pw = pd.prep_pair_decode_weights({k: _t(v, dev) for k, v in w.items()},
                                     cv, c_roi, c_dir, multires, DTYPES[dtype])
    return (common.pad_columns(_t(rng.normal(size=(30, cv)), dev,
                                  DTYPES[dtype]), pw["dims"][0]),
            _t(rng.integers(0, 30, p), dev, torch.int32),
            _t(0.6 * rng.normal(size=(p, 6)), dev),
            _t(rng.normal(size=(n_rays, c_roi + c_dir)), dev, DTYPES[dtype]),
            pw, _t(rng.integers(0, n_rays, p), dev, torch.int32)
            if indexed else None)


# P = 1000: not a multiple of either type's rows per block (64, 32)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("indexed", [True, False])  # global rows; dense layout
def test_pair_decode_kernel_matches_plain(dev, dtype, indexed):
    args = _pair_case(np.random.default_rng(19), dev, dtype, 1000, 50, indexed)
    before = pd.pair_decode.launches
    got = pd.pair_decode(*args)
    assert pd.pair_decode.launches == before + 1
    _close(got, pd.pair_decode_plain(*args), ATOL[dtype])


# rows of K6 (20 a ray in the dense layout): less than one tile; a ragged
# last tile (of 64 rows in bf16, 32 in f32); more tiles than one round of the
# persistent bf16 grid (one block per SM)
PAIR_SIZES = {"under one tile": 40, "ragged": 1000,
              "persistent": 20 * 846}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("size", list(PAIR_SIZES))
def test_pair_decode_rows_below_the_count(dev, dtype, size):
    """K6 with the row count n_rows (0, a partial tile, a multiple of 64,
    past one round of the grid, P and past P), indexed and dense, against
    its plain version: rows at or past the count exactly 0, the rows below
    it the bits of the call without a count; two calls give the same
    bits."""
    p = PAIR_SIZES[size]
    if size == "persistent":
        plan = common.decode_plan("K6", 400, n=p, sm_count=cuda.sm_count(dev))
        assert plan["tiles"] > plan["blocks"]
    for indexed in (True, False):
        args = _pair_case(np.random.default_rng(29), dev, dtype, p, p // 20,
                          indexed)
        full = pd.pair_decode(*args)
        again = pd.pair_decode(*args)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(full, again))
        _close(full, pd.pair_decode_plain(*args), ATOL[dtype])
        for n in sorted({0, 37, 64, 64 * cuda.sm_count(dev) + 100, p, p + 5}):
            n_rows = torch.tensor(n, dtype=torch.int32, device=dev)
            before = pd.pair_decode.launches
            got = pd.pair_decode(*args, n_rows=n_rows)
            assert pd.pair_decode.launches == before + 1
            _close(got, pd.pair_decode_plain(*args, n_rows=n_rows),
                   ATOL[dtype])
            k = min(n, p)
            for g, f in zip(got, full):
                assert g.shape == (p,) and (g[k:] == 0).all()
                assert torch.equal(g[:k], f[:k])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ief_decode_kernel_matches_plain(dev, dtype):
    rng = np.random.default_rng(12)
    n, c_end, c_rc, c_pos, c_dir = 100, 128, 155, 51, 27
    w = {"enc_w": rng.normal(size=(1, 16)), "enc_b": 0.1 * rng.normal(size=(16,))}
    _mlp_weights(rng, "", c_end + c_rc + c_pos + 16, 256, w)
    pw = ied.prep_ief_weights({k: _t(v, dev) for k, v in w.items()}, c_end,
                              c_rc, c_pos, c_dir, DTYPES[dtype])
    args = tuple(_t(rng.normal(size=(n, c)), dev, DTYPES[dtype])
                 for c in (c_end, c_rc, c_pos))
    before = ied.ief_decode.launches
    _close(ied.ief_decode(*args, pw), ied.ief_decode_plain(*args, pw),
           ATOL[dtype])
    assert ied.ief_decode.launches == before + 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_valid", [False, True])
def test_segment_max0_kernel_matches_plain(dev, dtype, with_valid):
    rng = np.random.default_rng(13)
    n, c, s = 5000, 64, 50  # segments 40..49 stay empty
    data = _t(np.abs(rng.normal(size=(n, c))), dev, DTYPES[dtype])
    data[::7] = 0  # post-ReLU zeros
    ids = _t(rng.integers(0, 40, n), dev, torch.int32)
    valid = _t(rng.random(n) < 0.7, dev, torch.bool) if with_valid else None
    before = segment.segment_max0.launches
    got = segment.segment_max0(data, ids, s, valid)
    _close(got, segment.segment_max0_plain(data, ids, s, valid), 0.0)  # exact
    assert got.dtype == data.dtype and (got[40:] == 0).all()
    assert segment.segment_max0.launches == before + 1


def test_depth_completer_card_matches_cpu(dev):
    """A tiny two-stage model in f32, every valid pixel a point (no random
    draw): the card (kernels) against the CPU (plain versions)."""
    cfg = load_config(overrides={
        "mask_type": "all", "dataset": {"img_height": 48, "img_width": 64},
        "model": {"rgb_out": 8, "pnet_out": 16, "pnet_gf": 8,
                  "resnet_stages": [1, 1, 1, 1]},
        "refine": {"pnet_out": 16, "pnet_gf": 8},
        "grid": {"valid_sample_num": -1},
        "tpu": {"max_pairs_per_ray": 12, "compute_dtype": "float32"}})
    static = build_static(cfg, n_rays=48 * 64)
    rng = np.random.default_rng(14)
    depth = rng.uniform(0.6, 1.4, (96, 128)).astype(np.float32)
    depth[rng.random((96, 128)) < 0.3] = 0
    rgb = rng.integers(0, 255, (96, 128, 3), dtype=np.uint8)
    outs = []
    for device in (dev, "cpu"):
        # weights at unit activation scale: decoder outputs spread over (0, 1)
        g = torch.Generator().manual_seed(0)
        dc = DepthCompleter(
            cfg, lidf=randomize_weights_(build_lidf(cfg, static, g), g),
            refine=randomize_weights_(build_refine(cfg, static, g), g),
            device=device)
        outs.append(dc.complete(rgb, depth, (100.0, 100.0, 64.0, 48.0)))
    card, cpu = outs
    have = depth != 0
    assert card["depth"][have].tobytes() == depth[have].tobytes()
    # 1e-3 m on 99% of pixels: a 1e-6 difference can move a prediction
    # across a voxel boundary, and the refine then decodes another cell
    agree = np.abs(card["depth_pred"] - cpu["depth_pred"]) <= 1e-3
    assert agree.mean() >= 0.99, agree.mean()


# -- stage-1 training: K2, K3, the K5 gradient, a train step ------------------

def _decode_case(rng, dev, dtype, n=100, cv=128, c_roi=128, c_dir=27,
                 n_table=30, gf=64, kb=8, multires=8, pad=True):
    """K1/K2/K3's f32 operands (the default widths unless given), at the
    kernels' widths with ``pad`` (``pad_operands``, the table
    with zero columns as the model pads it), the inputs and cotangents."""
    c_embed = cv + c_roi + 6 * (1 + 2 * multires) + c_dir
    w = {"off_enc_w": rng.normal(size=(1, 16)),
         "off_enc_b": 0.1 * rng.normal(size=(16,))}
    _mlp_weights(rng, "off_", c_embed + 16, 4 * gf, w)
    _mlp_weights(rng, "prob_", c_embed, 4 * gf, w)
    for pre, bias in (("off_", 0.25), ("prob_", 0.5)):  # outputs in (0, 1)
        w[f"{pre}w4"] *= 0.25
        w[f"{pre}b4"] = np.full((1,), bias)
    w32 = rd.split_ray_decode_weights({k: _t(v, dev) for k, v in w.items()},
                                      cv, c_roi, c_dir, multires,
                                      DTYPES[dtype])
    if pad:
        w32 = common.pad_operands(w32, rd.FORMAT)
    args = (common.pad_columns(_t(rng.normal(size=(n_table, cv)), dev),
                               w32["dims"][0]),
            _t(rng.integers(0, n_table, (n, kb)), dev, torch.int32),
            _t(0.6 * rng.normal(size=(n, kb, 6)), dev),
            _t(rng.normal(size=(n, c_roi + c_dir)), dev, DTYPES[dtype]))
    cot = (_t(rng.normal(size=(n, kb)), dev),
           _t(rng.normal(size=(n, kb)), dev))
    return w32, args, cot


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ray_decode_save_kernel_matches_plain(dev, dtype):
    rng = np.random.default_rng(15)
    w32, args, _ = _decode_case(rng, dev, dtype)
    w = common.cast_operands(w32, rd.FORMAT, DTYPES[dtype])
    before = rd.ray_decode_save.launches
    off, logit, saves = rd.ray_decode_save(*args, w)
    assert rd.ray_decode_save.launches == before + 1
    # K2 is K1 plus stores: the same bits
    k1 = rd.ray_decode(*args, w)
    assert torch.equal(off, k1[0]) and torch.equal(logit, k1[1])
    ref = rd.ray_decode_plain(*args, w, saves=True)
    _close((off, logit), ref[:2], ATOL[dtype])
    for got, want in zip(saves, ref[2]):
        assert got.dtype == DTYPES[dtype]
        _close(got, want, ATOL[dtype])


def _ief_case(rng, dev, dtype, n, c_end=128, c_rc=155, gf=64):
    c_pos, c_dir = 51, 27
    w = {"enc_w": rng.normal(size=(1, 16)), "enc_b": 0.1 * rng.normal(size=(16,))}
    _mlp_weights(rng, "", c_end + c_rc + c_pos + 16, 4 * gf, w)
    pw = ied.prep_ief_weights({k: _t(v, dev) for k, v in w.items()}, c_end,
                              c_rc, c_pos, c_dir, DTYPES[dtype])
    end, rc, pos = (_t(rng.normal(size=(n, c)), dev, DTYPES[dtype])
                    for c in (c_end, c_rc, c_pos))
    return (common.pad_columns(end, pw["dims"][0]), rc, pos), pw


def _save_close(got, want, dtype):
    """K2's saves against the plain version's within an ulp of the largest
    value (chip_smoke's TRAIN_TOL): a save is an f32 sum of many terms
    rounded to the compute type, and summing in another order moves it by
    an ulp of its summands, which near a cancellation is many ulps of the
    value itself. bf16: 2^-7 of the largest value; f32: 1e-5."""
    g, r = got.float(), want.float()
    assert got.dtype == DTYPES[dtype] and g.shape == r.shape
    assert torch.isfinite(g).all()
    if g.numel():
        ulp = 2.0 ** -7 if dtype == "bfloat16" else 1e-5
        assert (g - r).abs().max() <= ulp * r.abs().max()


# rays of K1/K2 (K4 decodes 8 times as many rows): a ragged last tile (tiles
# of 8 rays / 64 rows in bf16, 4 / 32 in f32); less than one tile; none; and
# more tiles than one round of the persistent bf16 grid (one block per SM)
EDGE_SIZES = {"ragged": 100, "under one tile": 3, "none": 0,
              "persistent": 8 * 132 * 2 + 5}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("size", list(EDGE_SIZES))
def test_forward_decodes_at_edge_sizes(dev, dtype, size):
    """K1, K2 and K4 against their plain versions; the forward has no
    atomics, so two launches give the same bits, and K2's outputs are K1's
    bits."""
    n = EDGE_SIZES[size]
    if size == "persistent":  # each block walks more than one tile
        for kernel, rows in (("K1", n), ("K4", 8 * n)):
            plan = common.decode_plan(kernel, 240, 160, n=rows,
                                      sm_count=cuda.sm_count(dev))
            assert plan["tiles"] > plan["blocks"]
    rng = np.random.default_rng(23)
    w32, args, _ = _decode_case(rng, dev, dtype, n=n)
    w = common.cast_operands(w32, rd.FORMAT, DTYPES[dtype])
    k1, again = rd.ray_decode(*args, w), rd.ray_decode(*args, w)
    off, logit, saves = rd.ray_decode_save(*args, w)
    saves_again = rd.ray_decode_save(*args, w)[2]
    ref = rd.ray_decode_plain(*args, w, saves=True)
    torch.cuda.synchronize()
    for a, b in zip((*k1, *saves), (*again, *saves_again)):
        assert torch.equal(a, b)
    assert torch.equal(off, k1[0]) and torch.equal(logit, k1[1])
    assert off.shape == (n, 8)
    _close(k1, ref[:2], ATOL[dtype])
    for got, want in zip(saves, ref[2]):
        _save_close(got, want, dtype)
    rows, pw = _ief_case(rng, dev, dtype, 8 * n)
    got = ied.ief_decode(*rows, pw)
    assert torch.equal(got, ied.ief_decode(*rows, pw))
    assert got.shape == (8 * n,)
    _close(got, ied.ief_decode_plain(*rows, pw), ATOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("size", list(EDGE_SIZES))
def test_save_all_decodes_at_edge_sizes(dev, dtype, size):
    """K2 'all' against ``ray_decode_plain(saves='all')``: its outputs and
    its l1 saves are K2's bits (the same decode, more stores), two launches
    give the same bits, the offsets and logit before the squash lie within
    the outputs' tolerance, the first offset is init_offset exactly, h2 and
    h3 within an ulp of their largest value."""
    n = EDGE_SIZES[size]
    rng = np.random.default_rng(24)
    w32, args, _ = _decode_case(rng, dev, dtype, n=n)
    w = common.cast_operands(w32, rd.FORMAT, DTYPES[dtype])
    before = rd.ray_decode_save_all.launches
    off, logit, saves = rd.ray_decode_save_all(*args, w)
    assert rd.ray_decode_save_all.launches == before + 1
    again = rd.ray_decode_save_all(*args, w)
    k2 = rd.ray_decode_save(*args, w)
    ref = rd.ray_decode_plain(*args, w, saves="all")
    torch.cuda.synchronize()
    names = rd.save_names(2, "all")
    assert len(saves) == len(names)
    for a, b in zip((off, logit, *saves), (again[0], again[1], *again[2])):
        assert torch.equal(a, b)
    assert torch.equal(off, k2[0]) and torch.equal(logit, k2[1])
    for a, b in zip(saves[:3], k2[2]):
        assert torch.equal(a, b)
    _close((off, logit), ref[:2], ATOL[dtype])
    for name, got, want in zip(names, saves, ref[2]):
        assert got.shape == want.shape, name
        if name == "off0":
            assert torch.equal(got, want)
        elif name.startswith("off") or name == "logit":
            assert got.dtype == torch.float32
            _close(got, want, ATOL[dtype])
        else:
            _save_close(got, want, dtype)


def test_decode_plan_is_the_kernels_layout(dev):
    """ops/decode_common.py::decode_plan's shared memory is the kernels' own
    (each C library reports its layout's size): K1, K2 'all', K4, K6, at
    every imnet_gf the kernels are compiled for, at the default widths, the
    reference's options' (W1-W7: kp 640, crp 288, 544 and 1056; K4's rows
    464, 720 and 1616, K6's 528, 784, 800 and 1696) and the limits, the
    single layout where the double one does not fit, the chunked one where
    neither does, f32 blocks of 16 rows where 32 do not fit; and K3's Pass
    A (``bwd_smem``) at 64, 32 and 16 rows a tile, -1 where the library
    holds no such instance (``bwd_held``)."""
    k1 = cuda.library("ray_decode").idt_ray_decode_smem
    k2all = cuda.library("ray_decode").idt_ray_decode_save_all_smem
    k4 = cuda.library("ief_decode").idt_ief_decode_smem
    k6 = cuda.library("pair_decode").idt_pair_decode_smem
    k1.argtypes = k2all.argtypes = [cuda.I64] * 4
    k4.argtypes = k6.argtypes = [cuda.I64] * 3
    k1.restype = k2all.restype = k4.restype = k6.restype = ctypes.c_longlong
    layouts = set()
    for g in common.DECODER_GF:
        for bf16 in (True, False):
            for kp, crp in ((240, 160), (256, 256), (368, 160), (32, 16),
                            (240, 288), (240, 544), (640, 160), (640, 544),
                            (common.MAX_KP["K1"], common.MAX_CRP)):
                plan = common.decode_plan("K1", kp, crp, is_bf16=bf16, g=g)
                layouts.add((plan["layout"], plan["rows_per_tile"]))
                assert k1(kp, crp, g, bf16) == plan["smem"]["total"]
                assert k2all(kp, crp, g, bf16) == common.decode_plan(
                    "K2all", kp, crp, is_bf16=bf16, g=g)["smem"]["total"]
            for kp in (336, 384, 16, 464, 720, 944, 1616, common.MAX_KP["K4"]):
                plan = common.decode_plan("K4", kp, is_bf16=bf16, g=g)
                layouts.add((plan["layout"], plan["rows_per_tile"]))
                assert k4(kp, g, bf16) == plan["smem"]["total"]
            for kp in (400, 528, 784, 800, 944, common.MAX_KP["K6"], 16):
                plan = common.decode_plan("K6", kp, is_bf16=bf16, g=g)
                layouts.add((plan["layout"], plan["rows_per_tile"]))
                assert k6(kp, g, bf16) == plan["smem"]["total"]
        k3 = cuda.library(f"ray_decode_bwd_g{g}").idt_ray_decode_bwd_smem
        k3.argtypes = [cuda.I64] * 6
        k3.restype = ctypes.c_longlong
        for crp in (160, 288, 544, 1056):
            small = rd.bwd_plan(1, 240, crp, 2, True, 132, g=g)["small_size"]
            for m, bf16 in ((64, True), (32, True), (32, False), (16, True),
                            (16, False)):
                built = rd.bwd_held(m, g, bf16)
                want = rd.bwd_smem(m, g, crp, 2, small, bf16) if built else -1
                assert k3(m, crp, 2, small, g, bf16) == want, (g, crp, m)
    assert {("single", 64), ("chunked", 64), ("f32", 32),
            ("f32", 16)} <= layouts


def test_k3_pass_a_blocks_an_sm_hold_the_plans_tiles(dev):
    """The card holds one K3 Pass A block an SM at the widths the plan
    takes (the default widths and W3's and W4's per-ray widths, imnet_gf 8
    to 128, bf16 and f32), and the plan sizes its grid for what a block
    holds: two 64-row tiles (the wgmma instance, bf16), one of 32 or 16
    rows otherwise. So two 64-row tiles are in flight on each SM."""
    for g in common.DECODER_GF:
        occ = cuda.library(
            f"ray_decode_bwd_g{g}").idt_ray_decode_bwd_blocks_per_sm
        occ.argtypes = [cuda.I64] * 6
        occ.restype = ctypes.c_longlong
        for crp in (160, 288, 544):
            for bf16 in (True, False):
                plan = rd.bwd_plan(1000, 240, crp, 2, bf16, 132, g=g,
                                   c_vox=128)
                m = plan["rows_per_tile"]
                got = occ(m, crp, 2, plan["small_size"], g, bf16)
                assert got == 1, (g, crp, bf16, m, got)
                assert plan["tile_slots"] == (2 if m == 64 else 1)
                assert plan["blocks_a"] == min(132 * plan["tile_slots"],
                                               plan["tiles_per_chunk"])


def _rel_norm(a, b):
    a, b = a.double(), b.double()
    return ((a - b).norm() / b.norm().clamp(min=1e-30)).item()


# (rays, chunk rays, split rows): a ragged last tile (tiles of 8 rays in
# bf16, 4 in f32); many tiles; less than one tile; several chunks of the
# operand streams with a ragged last one, and Pass B splits that end inside
# a shared-memory stage
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,chunk,split", [
    (100, None, None), (1000, None, None), (3, None, None), (100, 24, 40),
    (203, 64, 1000)])
@pytest.mark.parametrize("from_saves", [True, False])  # kernel_save; kernel
def test_ray_decode_bwd_kernel_matches_plain(dev, dtype, n, chunk, split,
                                             from_saves, monkeypatch):
    _bwd_matches_plain(dev, dtype, n, chunk, split,
                       "l1" if from_saves else None, monkeypatch)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,chunk,split", [
    (100, None, None), (1000, None, None), (3, None, None), (100, 24, 40),
    (203, 64, 1000)])
def test_ray_decode_bwd_all_kernel_matches_plain(dev, dtype, n, chunk, split,
                                                 monkeypatch):
    """K3 from K2 'all''s full saves (``kernel_save_all``), as above."""
    _bwd_matches_plain(dev, dtype, n, chunk, split, "all", monkeypatch)


def _k2_saves(args, w, saves):
    """K2's (``saves`` 'l1') or K2 'all''s saves of ``args``, or None."""
    if saves is None:
        return None
    fwd = rd.ray_decode_save if saves == "l1" else rd.ray_decode_save_all
    return fwd(*args, w)[2]


def _bwd_matches_plain(dev, dtype, n, chunk, split, saves_of, monkeypatch):
    if chunk is not None:
        monkeypatch.setattr(rd, "K3_CHUNK_RAYS", chunk)
        monkeypatch.setattr(rd, "K3_SPLIT_ROWS", split)
        assert rd.bwd_plan(n, 240, 160, 2, dtype == "bfloat16", 132, chunk,
                           split)["n_chunks"] > 1
    rng = np.random.default_rng(16)
    w32, args, cot = _decode_case(rng, dev, dtype, n=n)
    w = common.cast_operands(w32, rd.FORMAT, DTYPES[dtype])
    saves = _k2_saves(args, w, saves_of)
    before = rd.ray_decode_bwd.launches
    d_tab, d_rf, d_w = rd.ray_decode_bwd(*args, w, saves, *cot)
    assert rd.ray_decode_bwd.launches == before + 1
    ref = rd.ray_decode_bwd_plain(*args, w32, *cot, dtype=DTYPES[dtype],
                                  saved=saves)
    torch.cuda.synchronize()
    # f32: the same algebra in another order (1e-4 of the norm); bf16: the
    # kernel rounds each cotangent to bf16 before its product, as the JAX
    # kernel does, the plain autograd does not (2e-2 of the norm)
    tol = 1e-4 if dtype == "float32" else 2e-2
    got = {"d_table": d_tab, "d_ray_feat": d_rf, **d_w}
    want = {"d_table": ref[0], "d_ray_feat": ref[1], **ref[2]}
    for k, g in got.items():
        assert torch.isfinite(g).all(), k
        assert _rel_norm(g, want[k]) <= tol, (k, _rel_norm(g, want[k]))
    # deterministic weight gradients (fixed-order sums over the blocks)
    again = rd.ray_decode_bwd(*args, w, saves, *cot)[2]
    for k in d_w:
        assert torch.equal(again[k], d_w[k]), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("saves_of", ["l1", None, "all"])  # each K3 instance
def test_ray_decode_bwd_d_vox_table_is_deterministic(dev, dtype, saves_of,
                                                     monkeypatch):
    """Three K3 launches on the same inputs give the same d_vox_table bits,
    as the JAX kernel's fixed-order sums do: 4,000 rays over 30 cells, so
    that every block's tiles add into the same cells, in three chunks."""
    monkeypatch.setattr(rd, "K3_CHUNK_RAYS", 1500)
    monkeypatch.setattr(rd, "K3_SPLIT_ROWS", 1000)
    rng = np.random.default_rng(18)
    w32, args, cot = _decode_case(rng, dev, dtype, n=4000)
    w = common.cast_operands(w32, rd.FORMAT, DTYPES[dtype])
    saves = _k2_saves(args, w, saves_of)
    wgmma = rd.ray_decode_bwd.wgmma_launches
    first = rd.ray_decode_bwd(*args, w, saves, *cot)
    for _ in range(2):
        again = rd.ray_decode_bwd(*args, w, saves, *cot)
        assert torch.equal(again[0], first[0])
        assert torch.equal(again[1], first[1])
        for k in first[2]:
            assert torch.equal(again[2][k], first[2][k]), k
    # bf16 at the default widths: the 64-row Pass A on wgmma, each launch
    assert rd.ray_decode_bwd.wgmma_launches - wgmma == \
        (3 if dtype == "bfloat16" else 0)


# -- the decoders' other widths: imnet_gf 32 (the smoke and convergence
# configs: 128-64-32-1, pnet_out 64, rgb_out 16) and 8 (the tiny CLI model:
# 32-16-8-1; pnet_out 40, not a multiple of 16, exercises the narrow table)
WIDTHS = {32: {"cv": 64, "c_roi": 64}, 8: {"cv": 40, "c_roi": 32}}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gf", list(WIDTHS))
def test_forward_decodes_at_every_width(dev, dtype, gf):
    """K1, K2 (both save modes), K4 and K6 (``global`` rows and the dense
    layout) at imnet_gf 32 and 8 against their plain versions, over more
    tiles than one round of the persistent bf16 grid: K2's outputs are
    K1's bits, two launches give the same bits."""
    n = 8 * 132 * 2 + 5
    rng = np.random.default_rng(40 + gf)
    wd = WIDTHS[gf]
    w32, args, _ = _decode_case(rng, dev, dtype, n=n, gf=gf, **wd)
    w = common.cast_operands(w32, rd.FORMAT, DTYPES[dtype])
    counts = (rd.ray_decode.launches, rd.ray_decode_save.launches,
              rd.ray_decode_save_all.launches)
    k1, again = rd.ray_decode(*args, w), rd.ray_decode(*args, w)
    off, logit, saves = rd.ray_decode_save(*args, w)
    off_a, logit_a, saves_a = rd.ray_decode_save_all(*args, w)
    assert (rd.ray_decode.launches, rd.ray_decode_save.launches,
            rd.ray_decode_save_all.launches) == (counts[0] + 2, counts[1] + 1,
                                                 counts[2] + 1)
    ref = rd.ray_decode_plain(*args, w, saves="all")
    torch.cuda.synchronize()
    for a, b in zip(k1, again):
        assert torch.equal(a, b)
    for o in ((off, logit), (off_a, logit_a)):
        assert torch.equal(o[0], k1[0]) and torch.equal(o[1], k1[1])
    _close(k1, ref[:2], ATOL[dtype])
    for got, want in zip(saves, ref[2][:3]):
        _save_close(got, want, dtype)
    for name, got, want in zip(rd.save_names(2, "all"), saves_a, ref[2]):
        assert got.shape == want.shape, name
        if name == "off0":
            assert torch.equal(got, want)
        elif name.startswith("off") or name == "logit":
            _close(got, want, ATOL[dtype])
        else:
            _save_close(got, want, dtype)
    rows, pw = _ief_case(rng, dev, dtype, 8 * n, c_end=wd["cv"],
                         c_rc=wd["c_roi"] + 27, gf=gf)
    before = ied.ief_decode.launches
    got = ied.ief_decode(*rows, pw)
    assert ied.ief_decode.launches == before + 1
    assert torch.equal(got, ied.ief_decode(*rows, pw))
    _close(got, ied.ief_decode_plain(*rows, pw), ATOL[dtype])
    for indexed in (True, False):
        case = _pair_case(rng, dev, dtype, 20 * 846, 846, indexed, gf=gf,
                          **wd)
        before = pd.pair_decode.launches
        got = pd.pair_decode(*case)
        assert pd.pair_decode.launches == before + 1
        _close(got, pd.pair_decode_plain(*case), ATOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gf", list(WIDTHS))
@pytest.mark.parametrize("saves_of", ["l1", None, "all"])  # each K3 instance
def test_ray_decode_bwd_at_every_width(dev, dtype, gf, saves_of,
                                       monkeypatch):
    """K3's three instances at imnet_gf 32 and 8 against their plain
    versions (the tolerances of test_ray_decode_bwd_kernel_matches_plain),
    over several chunks and Pass B splits; a second launch gives the same
    bits of every gradient, d_vox_table included."""
    monkeypatch.setattr(rd, "K3_CHUNK_RAYS", 1500)
    monkeypatch.setattr(rd, "K3_SPLIT_ROWS", 1000)
    rng = np.random.default_rng(50 + gf)
    w32, args, cot = _decode_case(rng, dev, dtype, n=4000, gf=gf,
                                  **WIDTHS[gf])
    w = common.cast_operands(w32, rd.FORMAT, DTYPES[dtype])
    saves = _k2_saves(args, w, saves_of)
    before = rd.ray_decode_bwd.launches
    d_tab, d_rf, d_w = rd.ray_decode_bwd(*args, w, saves, *cot)
    assert rd.ray_decode_bwd.launches == before + 1
    ref = rd.ray_decode_bwd_plain(*args, w32, *cot, dtype=DTYPES[dtype],
                                  saved=saves)
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == "float32" else 2e-2
    got = {"d_table": d_tab, "d_ray_feat": d_rf, **d_w}
    want = {"d_table": ref[0], "d_ray_feat": ref[1], **ref[2]}
    for k, g in got.items():
        assert g.shape == want[k].shape and torch.isfinite(g).all(), k
        assert _rel_norm(g, want[k]) <= tol, (k, _rel_norm(g, want[k]))
    again = rd.ray_decode_bwd(*args, w, saves, *cot)
    assert torch.equal(again[0], d_tab) and torch.equal(again[1], d_rf)
    for k in d_w:
        assert torch.equal(again[2][k], d_w[k]), k


# imnet_gf: the widths of _decode_case at 64, WIDTHS at 32 and 8; 16 between
WGMMA_WIDTHS = {64: {}, 32: WIDTHS[32], 16: {"cv": 48, "c_roi": 48},
                8: WIDTHS[8]}


@pytest.mark.parametrize("gf", list(WGMMA_WIDTHS))
@pytest.mark.parametrize("kb", [4, 8, 16])
@pytest.mark.parametrize("saves_of", ["l1", None, "all"])  # each K3 instance
def test_ray_decode_bwd_wgmma_pass_a_matches_plain(dev, gf, kb, saves_of,
                                                   monkeypatch):
    """K3's 64-row bf16 Pass A (wgmma, two tiles a block) in each save mode
    against the plain version, at the tolerance of
    test_ray_decode_bwd_kernel_matches_plain, at imnet_gf 64, 32, 16 and 8
    and kb 4, 8 and 16: rays that end in a ragged last tile, in several
    chunks; the launch takes the wgmma path and a second one gives the same
    bits of every gradient."""
    monkeypatch.setattr(rd, "K3_CHUNK_RAYS", 700)
    monkeypatch.setattr(rd, "K3_SPLIT_ROWS", 1000)
    n = 1501  # tiles of 64 // kb rays: the last one ragged
    plan = rd.bwd_plan(n, 240, 160, 2, True, 132, 700, 1000, kb=kb)
    assert plan["n_chunks"] > 1 and n % plan["rays_per_tile"]
    rng = np.random.default_rng(90 + gf + kb)
    w32, args, cot = _decode_case(rng, dev, "bfloat16", n=n, kb=kb, gf=gf,
                                  **WGMMA_WIDTHS[gf])
    w = common.cast_operands(w32, rd.FORMAT, torch.bfloat16)
    saves = _k2_saves(args, w, saves_of)
    before = (rd.ray_decode_bwd.launches, rd.ray_decode_bwd.wgmma_launches)
    d_tab, d_rf, d_w = rd.ray_decode_bwd(*args, w, saves, *cot)
    assert (rd.ray_decode_bwd.launches,
            rd.ray_decode_bwd.wgmma_launches) == (before[0] + 1,
                                                  before[1] + 1)
    ref = rd.ray_decode_bwd_plain(*args, w32, *cot, dtype=torch.bfloat16,
                                  saved=saves)
    torch.cuda.synchronize()
    got = {"d_table": d_tab, "d_ray_feat": d_rf, **d_w}
    want = {"d_table": ref[0], "d_ray_feat": ref[1], **ref[2]}
    for k, g in got.items():
        assert g.shape == want[k].shape and torch.isfinite(g).all(), k
        assert _rel_norm(g, want[k]) <= 2e-2, (k, _rel_norm(g, want[k]))
    again = rd.ray_decode_bwd(*args, w, saves, *cot)
    assert torch.equal(again[0], d_tab) and torch.equal(again[1], d_rf)
    for k in d_w:
        assert torch.equal(again[2][k], d_w[k]), k


# the reference's model options (chip_smoke.py phase 41) at the kernels'
# operand widths: imnet_gf (W1 48, run at 64; W2 128), the per-ray roi
# features rgb_out * roi_out_bbox^2 (W3 64 * 4, W4 32 * 16), the voxel
# width pnet_out (W5 100, padded to 112; W6 512) with multires (W6 10); the
# operands padded where they are made (_decode_case, _pair_case, _ief_case)
MODEL_WIDTHS = {"W1": {"gf": 48}, "W2": {"gf": 128}, "W3": {"c_roi": 256},
                "W4": {"c_roi": 512}, "W5": {"cv": 100},
                "W6": {"cv": 512, "multires": 10},
                "W7": {"gf": 128, "cv": 512, "multires": 10, "c_roi": 1024}}


def _width_forwards(dev, dtype, wd):
    """K1, K2 (both save modes), K4 and K6 (``global`` rows and the dense
    layout) at the widths ``wd`` against their plain versions, over more
    tiles than one round of the persistent bf16 grid: K2's outputs are K1's
    bits, two launches the same bits."""
    n = 8 * 132 * 2 + 5
    rng = np.random.default_rng(80)
    w32, args, _ = _decode_case(rng, dev, dtype, n=n, **wd)
    w = common.cast_operands(w32, rd.FORMAT, DTYPES[dtype])
    counts = (rd.ray_decode.launches, rd.ray_decode_save.launches,
              rd.ray_decode_save_all.launches)
    k1, again = rd.ray_decode(*args, w), rd.ray_decode(*args, w)
    off, logit, saves = rd.ray_decode_save(*args, w)
    off_a, logit_a, saves_a = rd.ray_decode_save_all(*args, w)
    assert (rd.ray_decode.launches, rd.ray_decode_save.launches,
            rd.ray_decode_save_all.launches) == (counts[0] + 2, counts[1] + 1,
                                                 counts[2] + 1)
    ref = rd.ray_decode_plain(*args, w, saves="all")
    torch.cuda.synchronize()
    for a, b in zip(k1, again):
        assert torch.equal(a, b)
    for o in ((off, logit), (off_a, logit_a)):
        assert torch.equal(o[0], k1[0]) and torch.equal(o[1], k1[1])
    _close(k1, ref[:2], ATOL[dtype])
    for got, want in zip(saves, ref[2][:3]):
        _save_close(got, want, dtype)
    for name, got, want in zip(rd.save_names(2, "all"), saves_a, ref[2]):
        assert got.shape == want.shape, name
        if name == "off0":
            assert torch.equal(got, want)
        elif name.startswith("off") or name == "logit":
            _close(got, want, ATOL[dtype])
        else:
            _save_close(got, want, dtype)
    for indexed in (True, False):
        case = _pair_case(rng, dev, dtype, 20 * 846, 846, indexed, **wd)
        before = pd.pair_decode.launches
        got = pd.pair_decode(*case)
        assert pd.pair_decode.launches == before + 1
        assert torch.equal(got[0], pd.pair_decode(*case)[0])
        _close(got, pd.pair_decode_plain(*case), ATOL[dtype])


def _width_bwd(dev, dtype, wd, n_table=146):
    """K3's three instances at the widths ``wd`` against their plain
    versions (relative norm 1e-4 f32, 2e-2 bf16), over several chunks and
    Pass B splits; a second launch the same bits of every gradient. The
    table has about the default model's rows a cell (``n_table`` 146: 219
    at the training step's 640,000 pair rows over 2,916 cells), or 30
    cells of 1,067 rows each. There, in f32, the yardstick is the plain
    version in float64 (``utils/k3_against_f64.py``): on an H100 the f32
    plain version and K3 from K2 'all''s saves lay 2.4e-4-3.9e-4 from it
    (W3's d_vox_table 3.68e-4 and 3.85e-4), and K3 from K2's saves or
    recomputing 1.31e-4 from the f32 plain version at W3, its offset
    decoder's gradients too: K3 recomputes the IEF's forward in its
    own order, and with random cotangents over 1,067 rows a cell an input
    of a LeakyReLU or soft clamp within f32 rounding of its kink takes the
    other slope. K3 must then lie within 1e-4 plus twice the larger of the
    f32 plain version's distance from float64 and the float64 gradient's
    own movement under a jitter of the inputs at f32's rounding
    (``f64_reference``: sixteen ulps)."""
    from implicit_depth_torch.utils.k3_against_f64 import f64_reference, rel
    rng = np.random.default_rng(81)
    w32, args, cot = _decode_case(rng, dev, dtype, n=4000, n_table=n_table,
                                  **wd)
    w = common.cast_operands(w32, rd.FORMAT, DTYPES[dtype])
    tol = 1e-4 if dtype == "float32" else 2e-2
    exact = f64_reference(args, w32, cot) if (
        dtype == "float32" and n_table == 30) else None
    for saves_of in ("l1", None, "all"):
        saves = _k2_saves(args, w, saves_of)
        before = rd.ray_decode_bwd.launches
        d_tab, d_rf, d_w = rd.ray_decode_bwd(*args, w, saves, *cot)
        assert rd.ray_decode_bwd.launches == before + 1
        ref = rd.ray_decode_bwd_plain(*args, w32, *cot, dtype=DTYPES[dtype],
                                      saved=saves)
        torch.cuda.synchronize()
        got = {"d_table": d_tab, "d_ray_feat": d_rf, **d_w}
        want = {"d_table": ref[0], "d_ray_feat": ref[1], **ref[2]}
        for k, g in got.items():
            assert g.shape == want[k].shape and torch.isfinite(g).all(), k
            if exact is None:
                assert _rel_norm(g, want[k]) <= tol, (saves_of, k,
                                                      _rel_norm(g, want[k]))
            else:
                ref64, moved = exact
                bar = tol + 2 * max(rel(want[k], ref64[k]), moved[k])
                assert rel(g, ref64[k]) <= bar, (saves_of, k,
                                                 rel(g, ref64[k]), bar)
        again = rd.ray_decode_bwd(*args, w, saves, *cot)
        assert torch.equal(again[0], d_tab) and torch.equal(again[1], d_rf)
        for k in d_w:
            assert torch.equal(again[2][k], d_w[k]), k


# exact operands (test_decode_layouts_are_exact_on_exact_operands): the
# default widths (the double layout), W7 at imnet_gf 128 (K1, K4 and K6
# chunked) and W7's inputs at imnet_gf 64 (K1 single, K4 and K6 chunked)
EXACT_WIDTHS = {"default": {},
                "W7": MODEL_WIDTHS["W7"],
                "W7 at imnet_gf 64": {**MODEL_WIDTHS["W7"], "gf": 64}}


def _sparse(rng, a, b, k=8):
    """(a, b): k entries of 1/64 in each column, the others 0."""
    w = np.zeros((a, b))
    for j in range(b):
        w[rng.choice(a, min(k, a), replace=False), j] = 1 / 64
    return w


def _exact_mlp(rng, prefix, in_dim, gf4, b4, w):
    for i, (a, b) in enumerate([(in_dim, gf4), (gf4, gf4 // 2),
                                (gf4 // 2, gf4 // 4), (gf4 // 4, 1)], 1):
        w[f"{prefix}w{i}"] = _sparse(rng, a, b)
        w[f"{prefix}b{i}"] = np.zeros((b,))
    w[f"{prefix}b4"] = np.full((1,), b4)


@pytest.mark.parametrize("case", list(EXACT_WIDTHS))
def test_decode_layouts_are_exact_on_exact_operands(dev, case):
    """bf16 K1, K2, K4 and K6 (``global`` rows and the dense layout) on
    operands whose every f32 sum is exact, whatever its order: inputs in
    {0, 1, 2}, positions 0 (each sin 0, each cos 1), weights 1/64 at 8
    places a column and 0 elsewhere, biases 0 but the last, no offset
    encoder. Each activation is then the same f32 value in the kernel and
    in the plain version, rounded to the same bf16, so the two agree but
    for the soft clamp's rounding (1e-6) and K2's saves bit for bit; a
    column of X staged twice, dropped or shifted at a chunk's edge would
    move a sum by 1/64 of an input. The plans' layouts are the ones named
    (EXACT_WIDTHS)."""
    wd = EXACT_WIDTHS[case]
    gf, cv = wd.get("gf", 64), wd.get("cv", 128)
    c_roi, multires, c_dir = wd.get("c_roi", 128), wd.get("multires", 8), 27
    rng = np.random.default_rng(61)
    bf = torch.bfloat16

    def ints(*shape, dtype=bf):
        return _t(rng.integers(0, 3, shape), dev, dtype)

    c_embed = cv + c_roi + 6 * (1 + 2 * multires) + c_dir
    w = {"off_enc_w": np.zeros((1, 16)), "off_enc_b": np.zeros((16,))}
    _exact_mlp(rng, "off_", c_embed + 16, 4 * gf, 0.25, w)
    _exact_mlp(rng, "prob_", c_embed, 4 * gf, 0.5, w)
    wt = {k: _t(v, dev) for k, v in w.items()}
    wk = rd.prep_ray_decode_weights(wt, cv, c_roi, c_dir, multires, bf)
    n, kb = 8 * 132 * 2 + 5, 8
    table = common.pad_columns(ints(30, cv), wk["dims"][0])
    args = (table, _t(rng.integers(0, 30, (n, kb)), dev, torch.int32),
            torch.zeros((n, kb, 6), device=dev), ints(n, c_roi + c_dir))
    layouts = {"K1": common.decode_plan("K1", wk["pair_w1"].shape[0],
                                        wk["ray_w1"].shape[0],
                                        g=common.compiled_gf(gf))["layout"]}
    k1 = rd.ray_decode(*args, wk)
    off, logit, saves = rd.ray_decode_save(*args, wk)
    ref = rd.ray_decode_plain(*args, wk, saves=True)
    torch.cuda.synchronize()
    assert torch.equal(off, k1[0]) and torch.equal(logit, k1[1])
    for g, r in zip(k1, ref[:2]):
        assert (g - r).abs().max().item() <= 1e-6
    for name, g, r in zip(("e1", "z1p", "trig"), saves, ref[2]):
        assert torch.equal(g, r), name
    iw = {"enc_w": np.zeros((1, 16)), "enc_b": np.zeros((16,))}
    c_rc, c_pos = c_roi + c_dir, 51
    _exact_mlp(rng, "", cv + c_rc + c_pos + 16, 4 * gf, 0.25, iw)
    pw = ied.prep_ief_weights({k: _t(v, dev) for k, v in iw.items()}, cv, c_rc,
                              c_pos, c_dir, bf)
    rows = (common.pad_columns(ints(8 * n, cv), pw["dims"][0]),
            ints(8 * n, c_rc), ints(8 * n, c_pos))
    layouts["K4"] = common.decode_plan("K4", pw["w1"].shape[0],
                                       g=common.compiled_gf(gf))["layout"]
    got = ied.ief_decode(*rows, pw)
    assert (got - ied.ief_decode_plain(*rows, pw)).abs().max().item() <= 1e-6
    k6w = pd.prep_pair_decode_weights(wt, cv, c_roi, c_dir, multires, bf)
    layouts["K6"] = common.decode_plan("K6", k6w["w1"].shape[0],
                                       g=common.compiled_gf(gf))["layout"]
    p = 20 * 846
    for rays in (_t(rng.integers(0, 846, p), dev, torch.int32), None):
        case6 = (table, _t(rng.integers(0, 30, p), dev, torch.int32),
                 torch.zeros((p, 6), device=dev), ints(846, c_roi + c_dir),
                 k6w, rays)
        for g, r in zip(pd.pair_decode(*case6), pd.pair_decode_plain(*case6)):
            assert (g - r).abs().max().item() <= 1e-6
    assert layouts == {"default": {"K1": "double", "K4": "double",
                                   "K6": "double"},
                       "W7": {"K1": "chunked", "K4": "chunked",
                              "K6": "chunked"},
                       "W7 at imnet_gf 64": {"K1": "single", "K4": "chunked",
                                             "K6": "chunked"}}[case]


def _refuses(match, *calls):
    for call in calls:
        with pytest.raises(ValueError, match=match):
            call()


@pytest.mark.parametrize("case", [*MODEL_WIDTHS, "past the limits"])
def test_decode_kernels_refuse_a_width_they_are_not_built_for(dev, case,
                                                              monkeypatch):
    """W1-W7 (MODEL_WIDTHS): K1, K2 (both save modes), K3 (its three
    instances), K4 and K6 take the widths of the reference's options, each
    against its plain version in bf16 and f32, at this file's tolerances
    (imnet_gf 128 in f32 on blocks of 16 rows; W7's widest inputs in bf16
    on the chunked layout). Past the limits each refuses, naming the
    limit: imnet_gf 136 (K1-K3's wrappers; K4's and K6's operands, padded
    where they are made), kp 672, crp 1072, c_vox 528 (K3), K4's and K6's
    rows 1712."""
    monkeypatch.setattr(rd, "K3_CHUNK_RAYS", 1500)
    monkeypatch.setattr(rd, "K3_SPLIT_ROWS", 1000)
    rng = np.random.default_rng(60)
    if case in MODEL_WIDTHS:
        wd = MODEL_WIDTHS[case]
        gf, cv = wd.get("gf", 64), wd.get("cv", 128)
        for dtype in ("bfloat16", "float32"):
            _width_forwards(dev, dtype, wd)
            for n_table in (146, 30):
                _width_bwd(dev, dtype, wd, n_table)
            rows, pw = _ief_case(rng, dev, dtype, 8 * 2117, c_end=cv,
                                 c_rc=wd.get("c_roi", 128) + 27, gf=gf)
            before = ied.ief_decode.launches
            got = ied.ief_decode(*rows, pw)
            assert ied.ief_decode.launches == before + 1
            assert torch.equal(got, ied.ief_decode(*rows, pw))
            _close(got, ied.ief_decode_plain(*rows, pw), ATOL[dtype])
        return

    def k1_calls(pad=True, **wd):
        w32, args, cot = _decode_case(rng, dev, "bfloat16", n=10, pad=pad,
                                      **wd)
        w = common.cast_operands(w32, rd.FORMAT, torch.bfloat16)
        return [lambda f=f: f(*args, w) for f in (
            rd.ray_decode, rd.ray_decode_save, rd.ray_decode_save_all)] + [
            lambda: rd.ray_decode_bwd(*args, w, None, *cot)]

    _refuses("1 to 128", *k1_calls(pad=False, gf=136),
             lambda: ied.ief_decode(*_ief_case(rng, dev, "bfloat16", 10,
                                               gf=136)[0],
                                    _ief_case(rng, dev, "bfloat16", 10,
                                              gf=136)[1]),
             lambda: pd.pair_decode(*_pair_case(rng, dev, "bfloat16", 40, 2,
                                                True, gf=136)))
    # kp 672: c_vox 554 (padded to 560) with multires 8
    _refuses("kp up to 640", *k1_calls(cv=554))
    # crp 1072: roi 1045 + dir_e 27
    _refuses("crp up to 1056", *k1_calls(c_roi=1045))
    # K3's d_rows tile: c_vox 520 (padded to 528; kp 640 with multires 8)
    _refuses("c_vox up to 512", k1_calls(cv=520)[-1])
    # K4's and K6's rows 1712: c_end 1496 (+ 155 + 51), c_vox 1440 (+ 160
    # + 102)
    _refuses("kp up to 1696", lambda: ied.ief_decode(*_ief_case(
        np.random.default_rng(1), dev, "bfloat16", 10, c_end=1496)[0],
        _ief_case(np.random.default_rng(1), dev, "bfloat16", 10,
                  c_end=1496)[1]),
        lambda: pd.pair_decode(*_pair_case(rng, dev, "bfloat16", 40, 2, True,
                                           cv=1440)))


# -- every per-ray pair budget: kb 1 (16 rays of a bf16 tile, most rows
# idle), 3 and 12 (not dividing 64: trailing rows masked), 4 and 16 (whole
# tiles), 64 (a ray a tile; two 32-row blocks a ray in f32), at
# chip_smoke.py's tolerances: K1's outputs f32 1e-5, bf16 4e-3 (TOL); K2's
# saves within an ulp of their largest value (_save_close); K3 per
# gradient 1e-4 / 2e-2 of the norm (TRAIN_TOL)
BUDGETS = [1, 3, 4, 12, 16, 64]
K1_TOL = {"float32": 1e-5, "bfloat16": 4e-3}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kb", BUDGETS)
def test_forward_decodes_at_every_budget(dev, dtype, kb):
    """K1, K2 and K2 'all' at kb pair slots a ray against their plain
    versions, over more tiles than one round of the persistent bf16 grid
    and a ragged last tile: K2's outputs are K1's bits, two launches give
    the same bits, the first offset is init_offset exactly."""
    n = 16 * 132 * 2 + 5
    rng = np.random.default_rng(70 + kb)
    w32, args, _ = _decode_case(rng, dev, dtype, n=n, kb=kb)
    w = common.cast_operands(w32, rd.FORMAT, DTYPES[dtype])
    counts = (rd.ray_decode.launches, rd.ray_decode_save.launches,
              rd.ray_decode_save_all.launches)
    k1, again = rd.ray_decode(*args, w), rd.ray_decode(*args, w)
    off, logit, saves = rd.ray_decode_save(*args, w)
    off_a, logit_a, saves_a = rd.ray_decode_save_all(*args, w)
    assert (rd.ray_decode.launches, rd.ray_decode_save.launches,
            rd.ray_decode_save_all.launches) == (counts[0] + 2, counts[1] + 1,
                                                 counts[2] + 1)
    ref = rd.ray_decode_plain(*args, w, saves="all")
    torch.cuda.synchronize()
    assert k1[0].shape == (n, kb)
    for a, b in zip(k1, again):
        assert torch.equal(a, b)
    for o in ((off, logit), (off_a, logit_a)):
        assert torch.equal(o[0], k1[0]) and torch.equal(o[1], k1[1])
    _close(k1, ref[:2], K1_TOL[dtype])
    for got, want in zip(saves, ref[2][:3]):
        _save_close(got, want, dtype)
    for name, got, want in zip(rd.save_names(2, "all"), saves_a, ref[2]):
        assert got.shape == want.shape, name
        if name == "off0":
            assert torch.equal(got, want)
        elif name.startswith("off") or name == "logit":
            _close(got, want, K1_TOL[dtype])
        else:
            _save_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kb", BUDGETS)
@pytest.mark.parametrize("saves_of", ["l1", None, "all"])  # each K3 instance
def test_ray_decode_bwd_at_every_budget(dev, dtype, kb, saves_of,
                                        monkeypatch):
    """K3's three instances at kb pair slots a ray against their plain
    versions, over several chunks (sized by pair rows) and Pass B splits;
    a second launch gives the same bits of every gradient, d_vox_table
    included."""
    monkeypatch.setattr(rd, "K3_CHUNK_RAYS", 1500)
    monkeypatch.setattr(rd, "K3_SPLIT_ROWS", 1000)
    n = 3001
    assert rd.bwd_plan(n, 240, 160, 2, dtype == "bfloat16", 132, 1500, 1000,
                       kb=kb)["n_chunks"] > 1
    rng = np.random.default_rng(80 + kb)
    w32, args, cot = _decode_case(rng, dev, dtype, n=n, kb=kb)
    w = common.cast_operands(w32, rd.FORMAT, DTYPES[dtype])
    saves = _k2_saves(args, w, saves_of)
    before = rd.ray_decode_bwd.launches
    d_tab, d_rf, d_w = rd.ray_decode_bwd(*args, w, saves, *cot)
    assert rd.ray_decode_bwd.launches == before + 1
    ref = rd.ray_decode_bwd_plain(*args, w32, *cot, dtype=DTYPES[dtype],
                                  saved=saves)
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == "float32" else 2e-2
    got = {"d_table": d_tab, "d_ray_feat": d_rf, **d_w}
    want = {"d_table": ref[0], "d_ray_feat": ref[1], **ref[2]}
    for k, g in got.items():
        assert g.shape == want[k].shape and torch.isfinite(g).all(), k
        assert _rel_norm(g, want[k]) <= tol, (k, _rel_norm(g, want[k]))
    again = rd.ray_decode_bwd(*args, w, saves, *cot)
    assert torch.equal(again[0], d_tab) and torch.equal(again[1], d_rf)
    for k in d_w:
        assert torch.equal(again[2][k], d_w[k]), k


def test_decode_kernels_refuse_a_budget_past_the_limit(dev):
    """kb 65: every stage-1 decode wrapper names the limit of 64."""
    rng = np.random.default_rng(61)
    w32, args, cot = _decode_case(rng, dev, "bfloat16", n=10, kb=65)
    w = common.cast_operands(w32, rd.FORMAT, torch.bfloat16)
    for fn in (rd.ray_decode, rd.ray_decode_save, rd.ray_decode_save_all):
        with pytest.raises(ValueError, match="kb <= 64"):
            fn(*args, w)
    with pytest.raises(ValueError, match="kb <= 64"):
        rd.ray_decode_bwd(*args, w, None, *cot)


@pytest.mark.parametrize("decode_bwd", ["kernel_save", "kernel",
                                        "kernel_save_all", "xla"])
def test_ray_decode_train_launches_its_kernels(dev, decode_bwd):
    """kernel_save: K2 then K3 from its saves; kernel: K1 then K3
    recomputing layer 1; kernel_save_all: K2 'all' then K3 from its full
    saves; xla: K1 then autograd through the plain decode (no K3). Each
    gives the plain autograd's gradients."""
    rng = np.random.default_rng(20)
    w32, args, cot = _decode_case(rng, dev, "float32")
    counts = {f: f.launches for f in (rd.ray_decode, rd.ray_decode_save,
                                      rd.ray_decode_save_all,
                                      rd.ray_decode_bwd)}
    leaves = [args[0].clone().requires_grad_(), args[3].clone().requires_grad_()]
    off, logit = rd.ray_decode_train(leaves[0], args[1], args[2], leaves[1],
                                     w32, torch.float32,
                                     decode_bwd=decode_bwd)
    torch.autograd.backward((off, logit), cot)
    fwd = {"kernel_save": rd.ray_decode_save,
           "kernel_save_all": rd.ray_decode_save_all}.get(decode_bwd,
                                                          rd.ray_decode)
    bwd = rd.ray_decode_bwd if decode_bwd != "xla" else None
    for f, n in counts.items():
        assert f.launches == n + (f is fwd or f is bwd), f
    ref = rd.ray_decode_bwd_plain(*args, w32, *cot, dtype=torch.float32)
    for g, r in zip((leaves[0].grad, leaves[1].grad), ref[:2]):
        assert _rel_norm(g, r) <= 1e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["no valid row", "no rows", "odd channels",
                                  "sorted ids"])
def test_segment_max0_kernel_edge_cases(dev, dtype, case):
    """Exact against the plain version: no valid row (every segment 0), N =
    0, a channel count that is no whole number of 16-byte vectors (the
    scalar instance) and runs of rows in one segment (the pre-reduction)."""
    rng = np.random.default_rng(22)
    n = {"no rows": 0, "odd channels": 300}.get(case, 3000)
    c, s = (7 if case == "odd channels" else 128), 60
    data = _t(np.abs(rng.normal(size=(n, c))), dev, DTYPES[dtype])
    ids = rng.integers(0, s, n)
    ids = _t(np.sort(ids) if case == "sorted ids" else ids, dev, torch.int32)
    valid = _t(np.zeros(n, bool) if case == "no valid row"
               else rng.random(n) < 0.8, dev, torch.bool)
    got = segment.segment_max0(data, ids, s, valid)
    _close(got, segment.segment_max0_plain(data, ids, s, valid), 0.0)
    assert got.dtype == data.dtype and got.shape == (s, c)
    if case == "no valid row":
        assert (got == 0).all()


def test_segment_max0_is_one_launch(dev):
    """One call from Python: on the stream, beside the table's memset, only
    the merge kernel and, for bf16, its conversion to bf16; no PyTorch
    cast, mask copy or zero fill."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(23)
    data = _t(np.abs(rng.normal(size=(4000, 64))), dev, torch.bfloat16)
    ids = _t(rng.integers(0, 40, 4000), dev, torch.int32)
    valid = _t(rng.random(4000) < 0.7, dev, torch.bool)
    segment.segment_max0(data, ids, 50, valid)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        segment.segment_max0(data, ids, 50, valid)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "memset" not in e.name.lower()]
    assert len(kernels) == 2, kernels
    assert any("segment_max_kernel" in k for k in kernels), kernels
    assert any("to_bf16" in k for k in kernels), kernels


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segment_max0_backward_matches_plain(dev, dtype):
    rng = np.random.default_rng(18)
    n, c, s = 5000, 64, 50  # segments 40..49 stay empty
    data = _t(np.abs(rng.normal(size=(n, c))), dev, DTYPES[dtype])
    data[::7] = 0           # post-ReLU zeros tie
    ids = _t(rng.integers(0, 40, n), dev, torch.int32)
    valid = _t(rng.random(n) < 0.7, dev, torch.bool)
    cot = _t(rng.normal(size=(s, c)), dev)
    grads = []
    for fn in (segment.segment_max0, segment.segment_max0_plain):
        d = data.clone().requires_grad_()
        (fn(d, ids, s, valid).float() * cot).sum().backward()
        grads.append(d.grad)
    # the same shares: exact in f32; in bf16 one rounding of a share
    _close(grads[0], grads[1], 0.0 if dtype == "float32" else 4e-3)


# global at budget 1: the frame's valid pairs overflow it, so pairs are
# dropped, the spill slot fills and the per-ray competition runs over
# `pair_valid & decoded`
@pytest.mark.parametrize("tpu", [{"pairs_budget_per_ray": 0},
                                 {"pairs_budget_mode": "global",
                                  "pairs_budget_per_ray": 1}])
def test_pair_decode_modes_serve_and_train_on_the_card(dev, tpu):
    """The dense and global modes: eval frames launch K6 once and K1 never
    and agree with the CPU (plain version) in f32, every valid pixel a
    point; an f32 train step launches K6 once (forward; the backward
    recomputes the plain decode), K5 twice and K1-K3 never, and matches
    the CPU's step (plain autograd)."""
    from implicit_depth_torch.models.lidf import prepare_inputs

    def mode_cfg(valid_sample_num):
        return load_config(overrides={
            "mask_type": "all", "dataset": {"img_height": 48, "img_width": 64},
            "model": {"rgb_out": 8, "pnet_out": 16, "pnet_gf": 8,
                      "resnet_stages": [1, 1, 1, 1]},
            "refine": {"pnet_out": 16, "pnet_gf": 8},
            "grid": {"miss_sample_num": 256,
                     "valid_sample_num": valid_sample_num},
            "tpu": {"max_pairs_per_ray": 12, "compute_dtype": "float32",
                    **tpu}})

    cfg = mode_cfg(-1)  # every valid pixel a point: no draw to match
    static = build_static(cfg, n_rays=48 * 64)
    rng = np.random.default_rng(21)
    depth = rng.uniform(0.6, 1.4, (48, 64)).astype(np.float32)
    depth[rng.random((48, 64)) < 0.3] = 0
    rgb = rng.integers(0, 255, (48, 64, 3), dtype=np.uint8)
    intr = (60.0, 60.0, 32.0, 24.0)
    outs = []
    for device in (dev, "cpu"):
        g = torch.Generator().manual_seed(0)
        dc = DepthCompleter(
            cfg, lidf=randomize_weights_(build_lidf(cfg, static, g), g),
            refine=randomize_weights_(build_refine(cfg, static, g), g),
            device=device)
        k1, k6 = rd.ray_decode.launches, pd.pair_decode.launches
        outs.append(dc.complete(rgb, depth, intr))
        assert np.isfinite(outs[-1]["depth_pred"]).all()
        if device == dev:
            assert (rd.ray_decode.launches, pd.pair_decode.launches) == \
                (k1, k6 + 1)
    agree = np.abs(outs[0]["depth_pred"] - outs[1]["depth_pred"]) <= 1e-3
    assert agree.mean() >= 0.99, agree.mean()
    if "pairs_budget_mode" in tpu:
        with torch.inference_mode():
            valid = prepare_inputs(static, dc.device_batch(
                [rgb], [depth], [intr]), mask_type="all")["pair_valid"]
        assert valid.sum().item() > valid.shape[0] * valid.shape[1], \
            "the budget of 1 pair per ray drops no pair"
    from implicit_depth_torch.data.synthetic import synthetic_batch
    from implicit_depth_torch.geometry.sampling import (
        sample_masked_window,
        sample_valid_stratified,
    )
    from implicit_depth_torch.train.state import TrainState
    from implicit_depth_torch.train.steps import make_lidf_train_step
    tcfg = mode_cfg(512)
    tstatic = build_static(tcfg)
    raw = {k: torch.from_numpy(v)
           for k, v in synthetic_batch(0, 2, 48, 64).items()}
    vidx, _, _ = sample_valid_stratified(raw["valid_mask"] > 0.5,
                                         tstatic.n_valid, g)
    _, _, _, mstart = sample_masked_window(
        (raw["corrupt_mask"] > 0.5).reshape(2, -1), tstatic.n_rays, g)
    counted = {"pair_decode": pd.pair_decode, "ray_decode": rd.ray_decode,
               "ray_decode_save": rd.ray_decode_save,
               "ray_decode_bwd": rd.ray_decode_bwd,
               "segment_max0": segment.segment_max0}
    runs = []
    for device in (dev, torch.device("cpu")):
        g = torch.Generator().manual_seed(1)
        model = randomize_weights_(build_lidf(tcfg, tstatic, g), g).to(device)
        assert model.decode_mode != "per_ray"
        state = TrainState.create(model, tcfg.training, steps_per_epoch=10)
        before = {n: f.launches for n, f in counted.items()}
        losses = make_lidf_train_step(tcfg, model, device)(
            state, {k: v.to(device) for k, v in raw.items()}, None, 0,
            valid_idx=vidx, miss_start=mstart)
        if device == dev:
            torch.cuda.synchronize()
            assert {n: f.launches - before[n] for n, f in counted.items()} \
                == {"pair_decode": 1, "ray_decode": 0, "ray_decode_save": 0,
                    "ray_decode_bwd": 0, "segment_max0": 2}
        runs.append((losses, {n: p.grad.cpu() for n, p in
                              model.named_parameters()}))
    (l_card, g_card), (l_cpu, g_cpu) = runs
    for k in l_cpu:  # f32: the same algebra in another order
        np.testing.assert_allclose(l_card[k].item(), l_cpu[k].item(),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    for name, ref in g_cpu.items():
        # as test_train_step_card_matches_cpu: cuDNN's convolutions sum in
        # other orders through the whole model; plus 1e-7 for a sum that
        # cancels (the probability decoder's last bias: 5.6e-9 on the CPU,
        # 0 or -2.8e-9 on an H100)
        err = (g_card[name] - ref).double().norm().item()
        assert err <= 1e-3 * ref.double().norm().item() + 1e-7, (name, err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("indexed", [True, False])  # global rows; dense layout
def test_pair_decode_train_is_k6_forward_and_the_recompute_gradient(
        dev, dtype, indexed, monkeypatch):
    """The training pair decode on the card: its forward is K6 (the bits of
    ``pair_decode`` on ``cast_operands``, one launch; rows at or past
    the count 0), its backward the chunked plain recompute (chunks of 128
    rows, which divide neither the rows nor the dense layout's 20 slots a
    ray): the bits of ``pair_decode_bwd_chunked`` called on the same
    inputs, and one-shot autograd of ``pair_decode_plain`` within 5e-4 of
    each gradient's norm (f32 sums in another order: readings up to
    1.4e-4 on an H100, the offset encoder's weight, whose sum cancels;
    bf16 ray rows summed in f32 here, in bf16 by the one-shot gather:
    2^-7)."""
    monkeypatch.setattr(pd, "TRAIN_CHUNK_ROWS", 128)
    dt = DTYPES[dtype]
    rng = np.random.default_rng(23)
    vt, cells, pos, rf, _, rays = _pair_case(rng, dev, dtype, 1000, 50,
                                             indexed)
    c_embed = 128 + 128 + 102 + 27
    w = {"off_enc_w": rng.normal(size=(1, 16)),
         "off_enc_b": 0.1 * rng.normal(size=(16,))}
    _mlp_weights(rng, "off_", c_embed + 16, 256, w)
    _mlp_weights(rng, "prob_", c_embed, 256, w)
    params = {k: _t(v, dev).requires_grad_() for k, v in w.items()}
    vt = vt.float().requires_grad_()
    rf = rf.requires_grad_()
    n_rows = torch.tensor(777, dtype=torch.int32, device=dev) \
        if indexed else None
    g = torch.Generator(dev).manual_seed(2)
    cot = (torch.randn(1000, generator=g, device=dev),
           torch.randn(1000, generator=g, device=dev))

    def w32():
        return pd.pair_decode_weights(params, 128, 128, 27, 8, dt)

    before = pd.pair_decode.launches
    out = pd.pair_decode_train(vt, cells, pos, rf, w32(), rays, dtype=dt,
                               n_rows=n_rows)
    assert pd.pair_decode.launches == before + 1
    with torch.no_grad():
        k6 = pd.pair_decode(vt, cells, pos, rf, common.cast_operands(
            w32(), pd.FORMAT, dt), rays, n_rows=n_rows)
    for a, b in zip(out, k6):
        assert torch.equal(a, b)
    if indexed:
        assert (out[0][777:] == 0).all() and (out[1][777:] == 0).all()
    leaves = [vt, rf, *params.values()]
    got = torch.autograd.grad(out, leaves, cot)
    d_vox, d_ray, _ = pd.pair_decode_bwd_chunked(
        vt.detach(), cells, pos, rf.detach(), w32(), rays, n_rows, *cot,
        need=(True, True, True), dtype=dt)
    assert torch.equal(got[0], d_vox) and torch.equal(got[1], d_ray)
    rf32 = rf.detach().float().requires_grad_()
    plain = pd.pair_decode_plain(vt, cells, pos, rf32,
                                 common.round_biases(w32(), pd.FORMAT, dt),
                                 rays, n_rows=n_rows, dtype=dt)
    want = torch.autograd.grad(plain, [vt, rf32, *params.values()], cot)
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.isfinite(a).all()
        tol = 2.0 ** -7 if (i == 1 and dtype == "bfloat16") else 5e-4
        assert _rel_norm(a.float(), b.float()) <= tol, (i, _rel_norm(
            a.float(), b.float()))


def _segment_case(rng, dev, n, segments, c, dtype, big=0):
    """A chunk of a chunk_sort plan: rows (n, C), skewed keys with ``big``
    rows of one segment, sorted as the third chunk of a step (its keys and
    order local to it), and a table of nonzero values."""
    w = rng.pareto(1.2, size=segments) + 1e-3
    idx = np.concatenate([rng.choice(segments, size=n - big, p=w / w.sum()),
                          np.full(big, segments // 2)])
    index = _t(rng.permutation(idx), dev, torch.int64)
    keys, order = segment.chunk_sort(
        torch.cat([torch.zeros(2 * n, dtype=torch.int64, device=dev), index]),
        max(n, 1), segments)
    rows = _t(rng.normal(size=(n, c)), dev, DTYPES[dtype])
    table = _t(rng.normal(size=(segments, c)), dev)
    return (table, rows, keys[2 * n:], order[2 * n:]), index


def _segment_sum_f64_bound(table, rows, index):
    """index_put_(accumulate=True) in float64 of the rows onto the table,
    and the bound of f32 recursive summation at the kernel's depth (a run
    of a tile, a group's pieces, the groups, the table's add) times
    2^-24 times the sum of the magnitudes."""
    n = rows.shape[0]
    pieces = -(-n // segment.SUM_TILE_ROWS) + 1
    depth = (segment.SUM_TILE_ROWS + -(-pieces // segment.SUM_GROUPS)
             + segment.SUM_GROUPS + 1)
    ref = table.double().index_put_((index,), rows.double(), accumulate=True)
    mag = table.double().abs().index_put_((index,), rows.double().abs(),
                                          accumulate=True)
    return ref, depth * 2.0 ** -24 * mag


# n: one tile; a row count no tile multiple with one segment over 19 tiles;
# a single row
@pytest.mark.parametrize("c", [128, 155])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,big", [(64, 0), (3001, 1200), (1, 0)])
def test_segment_sum_kernel_is_the_plain_bits(dev, n, big, dtype, c):
    """The kernel sums in the plain version's order: the same bits, on two
    runs; against index_put_ in float64 within f32 summation's bound (the
    kernel sums in f32, in an order of its own); two launches."""
    rng = np.random.default_rng(31)
    (table, rows, keys, order), index = _segment_case(
        rng, dev, n, 40, c, dtype, big)
    before = segment.segment_sum_.launches
    got = [segment.segment_sum_(table.clone(), rows, keys, order)
           for _ in range(2)]
    assert segment.segment_sum_.launches == before + 4
    plain = segment.segment_sum_plain_(table.clone(), rows, keys, order)
    torch.cuda.synchronize()
    assert torch.equal(got[0], got[1]) and torch.equal(got[0], plain)
    ref, bound = _segment_sum_f64_bound(table, rows, index)
    assert ((got[0].double() - ref).abs() <= bound).all()


def test_segment_sum_at_the_cells_shape(dev):
    """A chunk of train.lidf.allpairs.b32's recompute: 131,072 rows onto the
    23,328 x 128 f32 voxel table, one cell taking 50,000 of them: the plain
    version's bits, the same bits twice, f32 summation's bound against
    float64, and no host sync in the sort or the sum."""
    rng = np.random.default_rng(32)
    n, segments = 131_072, 23_328
    (table, rows, _, _), index = _segment_case(
        rng, dev, n, segments, 128, "float32", big=50_000)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        keys, order = segment.chunk_sort(
            torch.cat([torch.zeros(2 * n, dtype=torch.int64, device=dev),
                       index]), n, segments)
        keys, order = keys[2 * n:], order[2 * n:]
        got = [segment.segment_sum_(table.clone(), rows, keys, order)
               for _ in range(2)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    plain = segment.segment_sum_plain_(table.clone(), rows, keys, order)
    assert torch.equal(got[0], got[1]) and torch.equal(got[0], plain)
    ref, bound = _segment_sum_f64_bound(table, rows, index)
    assert ((got[0].double() - ref).abs() <= bound).all()


@pytest.mark.parametrize("indexed", [True, False])  # global rows; dense layout
def test_pair_decode_recompute_sums_without_index_put(dev, indexed,
                                                      monkeypatch):
    """On the card the recompute lays the gathered rows' gradients back
    through the segment sum: no index_put_, index_add_ or scatter_add_ in
    pair_decode_bwd_chunked, two launches a table a chunk, and the same bits
    on two runs."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.add(func.name())
            return func(*args, **(kwargs or {}))

    monkeypatch.setattr(pd, "TRAIN_CHUNK_ROWS", 128)
    rng = np.random.default_rng(24)
    vt, cells, pos, rf, _, rays = _pair_case(rng, dev, "bfloat16", 1000, 50,
                                             indexed)
    c_embed = 128 + 128 + 102 + 27
    w = {"off_enc_w": rng.normal(size=(1, 16)),
         "off_enc_b": 0.1 * rng.normal(size=(16,))}
    _mlp_weights(rng, "off_", c_embed + 16, 256, w)
    _mlp_weights(rng, "prob_", c_embed, 256, w)
    w32 = pd.pair_decode_weights({k: _t(v, dev) for k, v in w.items()},
                                 128, 128, 27, 8, torch.bfloat16)
    n_rows = torch.tensor(777, dtype=torch.int32, device=dev) \
        if indexed else None
    g = torch.Generator(dev).manual_seed(3)
    cot = (torch.randn(1000, generator=g, device=dev),
           torch.randn(1000, generator=g, device=dev))
    runs = []
    for _ in range(2):
        before = (pd.pair_decode_bwd_chunked.chunks,
                  segment.segment_sum_.launches)
        with Ops() as ops:
            runs.append(pd.pair_decode_bwd_chunked(
                vt.float(), cells, pos, rf, w32, rays, n_rows, *cot,
                need=(True, True, True), dtype=torch.bfloat16))
        chunks = pd.pair_decode_bwd_chunked.chunks - before[0]
        assert chunks > 1
        assert segment.segment_sum_.launches - before[1] == 4 * chunks
        scatter = {n for n in ops.names
                   if any(k in n for k in ("index_put", "index_add",
                                           "scatter_add"))}
        assert not scatter, scatter
    torch.cuda.synchronize()
    for a, b in zip(runs[0][:2], runs[1][:2]):
        assert torch.equal(a, b)
    for k in runs[0][2]:
        assert torch.equal(runs[0][2][k], runs[1][2][k])


@pytest.mark.parametrize("budget", [8, 1])  # pad rows; dropped pairs
def test_global_frame_is_the_same_without_the_count(dev, budget, monkeypatch):
    """A served bf16 frame in the global mode: K6 decoding only the valid
    prefix (the count) gives the bits of K6 decoding every row, whose pad
    rows the scatter back then zeroes."""
    from implicit_depth_torch.models import lidf as lidf_mod

    cfg = load_config(overrides={
        "mask_type": "all", "dataset": {"img_height": 48, "img_width": 64},
        "model": {"rgb_out": 8, "pnet_out": 16, "pnet_gf": 8,
                  "resnet_stages": [1, 1, 1, 1]},
        "refine": {"pnet_out": 16, "pnet_gf": 8},
        "grid": {"valid_sample_num": -1},
        "tpu": {"max_pairs_per_ray": 12, "pairs_budget_mode": "global",
                "pairs_budget_per_ray": budget}})
    static = build_static(cfg, n_rays=48 * 64)
    rng = np.random.default_rng(31)
    depth = rng.uniform(0.6, 1.4, (48, 64)).astype(np.float32)
    depth[rng.random((48, 64)) < 0.3] = 0
    rgb = rng.integers(0, 255, (48, 64, 3), dtype=np.uint8)
    g = torch.Generator().manual_seed(0)
    dc = DepthCompleter(
        cfg, lidf=randomize_weights_(build_lidf(cfg, static, g), g),
        refine=randomize_weights_(build_refine(cfg, static, g), g),
        device=dev)
    assert dc.lidf.decode_mode == "global"
    counts = []
    original = lidf_mod.pair_decode

    def recorder(*a, n_rows=None, **kw):
        counts.append(int(n_rows.item()))
        return original(*a, n_rows=n_rows, **kw)

    monkeypatch.setattr(lidf_mod, "pair_decode", recorder)
    with_count = dc.complete(rgb, depth, (60.0, 60.0, 32.0, 24.0))
    monkeypatch.setattr(lidf_mod, "pair_decode",
                        lambda *a, n_rows=None, **kw: original(*a, **kw))
    without = dc.complete(rgb, depth, (60.0, 60.0, 32.0, 24.0))
    assert 0 < counts[0] <= 48 * 64 * budget
    if budget == 8:  # the frame's valid pairs leave pad rows
        assert counts[0] < 48 * 64 * budget
    for k in ("depth", "depth_pred"):
        assert with_count[k].tobytes() == without[k].tobytes(), k


def test_train_step_card_matches_cpu(dev):
    """One f32 train step of a tiny model at the kernels' decoder widths,
    on the card (K2, K3, K5) and on the CPU (plain versions)."""
    from implicit_depth_torch.data.synthetic import synthetic_batch
    from implicit_depth_torch.geometry.sampling import (
        sample_masked_window,
        sample_valid_stratified,
    )
    from implicit_depth_torch.train.state import TrainState
    from implicit_depth_torch.train.steps import make_lidf_train_step

    cfg = load_config(overrides={
        "dataset": {"img_height": 48, "img_width": 64},
        "model": {"rgb_out": 8, "pnet_out": 32, "pnet_gf": 8,
                  "resnet_stages": [1, 1, 1, 1]},
        "grid": {"miss_sample_num": 256, "valid_sample_num": 512},
        "tpu": {"max_pairs_per_ray": 12, "compute_dtype": "float32"}})
    static = build_static(cfg)
    raw = {k: torch.from_numpy(v) for k, v in synthetic_batch(0, 2, 48, 64).items()}
    g = torch.Generator().manual_seed(0)
    vidx, _, _ = sample_valid_stratified(raw["valid_mask"] > 0.5,
                                         static.n_valid, g)
    _, _, _, mstart = sample_masked_window(
        (raw["corrupt_mask"] > 0.5).reshape(2, -1), static.n_rays, g)
    runs = []
    for device in (dev, torch.device("cpu")):
        g = torch.Generator().manual_seed(1)
        model = randomize_weights_(build_lidf(cfg, static, g), g).to(device)
        state = TrainState.create(model, cfg.training, steps_per_epoch=10)
        batch = {k: v.to(device) for k, v in raw.items()}
        losses = make_lidf_train_step(cfg, model, device)(
            state, batch, None, 10, valid_idx=vidx, miss_start=mstart)
        runs.append((losses, {n: p.grad.cpu() for n, p in
                              model.named_parameters()}))
    (l_card, g_card), (l_cpu, g_cpu) = runs
    for k in l_cpu:  # f32: the same algebra in another order
        np.testing.assert_allclose(l_card[k].item(), l_cpu[k].item(),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    for name, ref in g_cpu.items():
        # 1e-3 of the norm: cuDNN's convolution backward and the atomics of
        # d_vox_table sum in other orders through the whole model
        assert _rel_norm(g_card[name], ref) <= 1e-3, (name, _rel_norm(
            g_card[name], ref))


# -- stage-2 training: K4's training entry, the refine step, checkpoints -------

def _ief_train_case(rng, dev, dtype, n):
    """Rows and live f32 parameters of the IEF decode at the kernel's
    widths; the f32 split operands from them (requiring gradients)."""
    c_end, c_rc, c_pos, c_dir = 128, 155, 51, 27
    w = {"enc_w": rng.normal(size=(1, 16)), "enc_b": 0.1 * rng.normal(size=(16,))}
    _mlp_weights(rng, "", c_end + c_rc + c_pos + 16, 256, w)
    params = {k: _t(v, dev).requires_grad_() for k, v in w.items()}
    rows = [_t(rng.normal(size=(n, c)), dev, dtype).requires_grad_(need)
            for c, need in ((c_end, True), (c_rc, False), (c_pos, True))]
    w32 = ied.split_ief_weights(params, c_end, c_rc, c_pos, c_dir, dtype)
    return rows, params, w32


def _ief_grads(out, rows, params, g):
    leaves = [t for t in rows if t.requires_grad] + list(params.values())
    # the split of the parameters is shared by both decodes' graphs
    return torch.autograd.grad(out, leaves, g, retain_graph=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1000, 3])
def test_ief_decode_train_is_k4_forward_and_the_plain_gradient(dev, dtype, n):
    """On the card the training IEF decode's forward is K4 (the bits of
    ``ief_decode`` on the operands ``prep_ief_weights`` makes, one launch)
    and its backward is autograd of ``ief_decode_plain`` on the same
    inputs, bit for bit; rc, which asks for no gradient, gets none."""
    dt = DTYPES[dtype]
    rows, params, w32 = _ief_train_case(np.random.default_rng(60), dev, dt, n)
    before = ied.ief_decode.launches
    out = ied.ief_decode_train(*rows, w32, dt)
    assert ied.ief_decode.launches == before + 1
    with torch.no_grad():
        k4 = ied.ief_decode(*rows, ied.prep_ief_weights(
            params, 128, 155, 51, 27, dt))
    assert torch.equal(out, k4)
    g = torch.randn(out.shape, generator=torch.Generator(dev).manual_seed(1),
                    device=dev)
    got = _ief_grads(out, rows, params, g)
    plain = ied.ief_decode_plain(
        *rows, common.round_biases(w32, ied.FORMAT, dt), dtype=dt)
    want = _ief_grads(plain, rows, params, g)
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        assert torch.equal(a, b)
    assert rows[1].grad is None


def _refine_cfg(dtype="bfloat16", **extra):
    # the kernels' decoder widths (K4 takes 256-128-64-1), a narrow trunk
    return load_config(overrides={
        "mask_type": "all", "dataset": {"img_height": 48, "img_width": 64},
        "model": {"rgb_out": 8, "pnet_out": 16, "pnet_gf": 8,
                  "resnet_stages": [1, 1, 1, 1]},
        "refine": {"pnet_out": 16, "pnet_gf": 8},
        "grid": {"miss_sample_num": 256, "valid_sample_num": 512},
        "tpu": {"max_pairs_per_ray": 12, "compute_dtype": dtype}, **extra})


def _refine_pair(cfg, static, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (randomize_weights_(build_lidf(cfg, static, g), g),
            randomize_weights_(build_refine(cfg, static, g), g))


def _refine_steps(dev, cfg, lidf, refine, batches):
    """Refine train steps on ``dev`` from copies of the given models; each
    step's draws from a generator seeded by its index. Returns the losses
    and the refine parameters after the steps."""
    import copy

    from implicit_depth_torch.train.state import TrainState
    from implicit_depth_torch.train.steps import make_refine_train_step

    lm, rm = copy.deepcopy(lidf).to(dev), copy.deepcopy(refine).to(dev)
    state = TrainState.create(rm, cfg.training, steps_per_epoch=10)
    step = make_refine_train_step(cfg, lm, rm, dev)
    losses = []
    for i, b in enumerate(batches):
        gen = torch.Generator(device=dev).manual_seed(i)
        out = step(state, {k: v.to(dev) for k, v in b.items()}, gen, 10)
        losses.append({k: v.item() for k, v in out.items()})
    return losses, {n: p.detach().cpu() for n, p in rm.named_parameters()}


def test_refine_steps_are_bit_identical_and_launch_their_kernels(dev):
    """Two refine steps from the same state, twice: the same losses and
    parameters bit for bit (no atomics on the path: the gathers' backward
    is PyTorch's sorted index_put_, K5's gradient counts its ties with an
    index_add_ of 0/1). Per step: K1 1 (the frozen stage 1), K4 2, K5 10."""
    from implicit_depth_torch.data.synthetic import synthetic_batch

    cfg = _refine_cfg()
    lidf, refine = _refine_pair(cfg, build_static(cfg))
    batches = [{k: torch.from_numpy(v) for k, v in
                synthetic_batch(60 + i, 2, 48, 64).items()} for i in range(2)]
    names = ("ray_decode", "ray_decode_save", "ray_decode_bwd")
    counts = {n: getattr(rd, n) for n in names}
    counts["ief_decode"] = ied.ief_decode
    counts["segment_max0"] = segment.segment_max0
    before = {n: f.launches for n, f in counts.items()}
    a = _refine_steps(dev, cfg, lidf, refine, batches)
    launched = {n: f.launches - before[n] for n, f in counts.items()}
    assert launched == {"ray_decode": 2, "ray_decode_save": 0,
                        "ray_decode_bwd": 0, "ief_decode": 4,
                        "segment_max0": 20}, launched
    b = _refine_steps(dev, cfg, lidf, refine, batches)
    assert a[0] == b[0]
    assert all(np.isfinite(v) for ls in a[0] for v in ls.values())
    for n in a[1]:
        assert torch.equal(a[1][n], b[1][n]), n
        assert not torch.equal(a[1][n], refine.state_dict()[n]), n


def test_refine_step_card_matches_cpu(dev):
    """One f32 refine step of a tiny model on the card (K1, K4, K5) and on
    the CPU (plain versions): losses within 1e-4, each refine gradient
    within 1e-3 of its norm (the refine PointNet's products and the decode
    sum in other orders)."""
    import copy

    from implicit_depth_torch.data.synthetic import synthetic_batch
    from implicit_depth_torch.models.lidf import prepare_inputs
    from implicit_depth_torch.train.state import TrainState
    from implicit_depth_torch.train.steps import make_refine_train_step

    cfg = _refine_cfg("float32")
    static = build_static(cfg)
    lidf, refine = _refine_pair(cfg, static, seed=1)
    raw = {k: torch.from_numpy(v) for k, v in synthetic_batch(62, 2, 48, 64).items()}
    gen = torch.Generator().manual_seed(2)
    inp = prepare_inputs(static, raw, train=True, generator=gen)
    noise = {k: torch.rand((2,), generator=gen) for k in ("apply", "bucket", "u")}
    runs = []
    for device in (dev, torch.device("cpu")):
        lm, rm = copy.deepcopy(lidf).to(device), copy.deepcopy(refine).to(device)
        state = TrainState.create(rm, cfg.training, steps_per_epoch=10)
        losses = make_refine_train_step(cfg, lm, rm, device)(
            state, {k: v.to(device) for k, v in raw.items()}, None, 10,
            valid_idx=inp["valid_idx"], miss_start=inp["miss_start"],
            noise={k: v.to(device) for k, v in noise.items()})
        runs.append((losses, {n: p.grad.cpu() for n, p in
                              rm.named_parameters()}))
    (l_card, g_card), (l_cpu, g_cpu) = runs
    for k in l_cpu:
        np.testing.assert_allclose(l_card[k].item(), l_cpu[k].item(),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    for name, ref in g_cpu.items():
        assert _rel_norm(g_card[name], ref) <= 1e-3, (name, _rel_norm(
            g_card[name], ref))


def _old_k4_operands(refine):
    """K4's operands straight from the decoder's weights, each cast as it
    is split (no f32 split in between): the operands a served frame took
    before the training decode shared the split."""
    w = refine.offset_dec.decode_weights()
    c_end, c_rc, c_pos, c_dir = (refine.dims[k] for k in
                                 ("c_end", "c_rc", "c_pos", "c_dir"))
    dtype = refine.dtype
    w1 = w["w1"]
    o1, o2 = c_end, c_end + (c_rc - c_dir)
    o3, o4 = o2 + c_pos, o2 + c_pos + c_dir
    kp = -(-(c_end + c_rc + c_pos) // 16) * 16
    a_vec, c_vec = common.rank1(w["enc_w"], w["enc_b"], w1[o4:], dtype)
    out = {"w1": common.pad_to(torch.cat([w1[:o1], w1[o1:o2], w1[o3:o4],
                                          w1[o2:o3]], 0), (kp, w1.shape[1])
                               ).to(dtype).contiguous(),
           "b1": w["b1"].float(), "a_vec": a_vec, "c_vec": c_vec}
    out.update({"w2": w["w2"].to(dtype).contiguous(),
                "b2": common.rounded(w["b2"], dtype),
                "w3": w["w3"].to(dtype).contiguous(),
                "b3": common.rounded(w["b3"], dtype),
                "w4": w["w4"].reshape(-1).to(dtype).contiguous(),
                "b4": w["b4"].reshape(1).float()})
    out["dims"] = (c_end, c_rc, c_pos)
    return out


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_served_frame_is_unchanged_by_the_training_decode(dev, dtype,
                                                          monkeypatch):
    """Serving goes on through K4 on the cached operands: a frame served
    is bit for bit the frame served with K4's operands made straight from
    the weights (``_old_k4_operands``)."""
    from implicit_depth_torch.models.refine import RefineModel

    cfg = _refine_cfg(dtype)
    static = build_static(cfg, n_rays=48 * 64)
    rng = np.random.default_rng(63)
    depth = rng.uniform(0.6, 1.4, (48, 64)).astype(np.float32)
    depth[rng.random((48, 64)) < 0.3] = 0
    rgb = rng.integers(0, 255, (48, 64, 3), dtype=np.uint8)
    frame = (rgb, depth, (60.0, 60.0, 32.0, 24.0))
    lidf, refine = _refine_pair(cfg, static, seed=3)
    dc = DepthCompleter(cfg, lidf=lidf, refine=refine, device=dev)
    now = dc.complete(*frame)
    old = _old_k4_operands(refine)
    new = refine.decode_operands()
    for k in ied.FORMAT.operands:
        assert torch.equal(old[k], new[k]), k
    monkeypatch.setattr(RefineModel, "decode_operands",
                        lambda self: _old_k4_operands(self))
    before = dc.complete(*frame)
    for k in ("depth", "depth_pred"):
        assert now[k].tobytes() == before[k].tobytes(), k


def test_checkpoint_saved_on_the_card_restores_on_the_cpu_and_back(dev,
                                                                     tmp_path):
    """A refine train state saved on the card restores into CPU models and,
    saved again from there, back onto the card: parameters, optimizer
    state and step bit for bit; a served frame from the restored pair
    equals the original pair's."""
    from implicit_depth_torch.data.synthetic import synthetic_batch
    from implicit_depth_torch.train.checkpoint import (
        Checkpointer,
        restore_params_only,
    )
    from implicit_depth_torch.train.state import TrainState

    cfg = _refine_cfg()
    static = build_static(cfg)
    lidf, refine = _refine_pair(cfg, static, seed=4)
    batch = {k: torch.from_numpy(v) for k, v in
             synthetic_batch(64, 2, 48, 64).items()}
    _, params = _refine_steps(dev, cfg, lidf, refine, [batch])
    rm = build_refine(cfg, static).to(dev)
    rm.load_state_dict({n: p.to(dev) for n, p in params.items()})
    state = TrainState.create(rm, cfg.training, steps_per_epoch=10)
    for p in rm.parameters():  # an optimizer state on the card
        p.grad = torch.ones_like(p)
    state.apply_gradients()
    Checkpointer(str(tmp_path / "card")).save(state, epoch=1)
    Checkpointer(str(tmp_path / "lidf")).save(lidf.to(dev), epoch=0)

    cpu_state = TrainState.create(build_refine(cfg, static), cfg.training,
                                  steps_per_epoch=10)
    cpu_state, _ = Checkpointer(str(tmp_path / "card")).restore(cpu_state)
    Checkpointer(str(tmp_path / "cpu")).save(cpu_state, epoch=1)
    back = TrainState.create(build_refine(cfg, static).to(dev), cfg.training,
                             steps_per_epoch=10)
    back, _ = Checkpointer(str(tmp_path / "cpu")).restore(back)
    assert cpu_state.step == back.step == state.step == 1
    for (n, p), pc, pb in zip(rm.named_parameters(),
                              cpu_state.model.parameters(),
                              back.model.parameters()):
        assert pc.device.type == "cpu" and pb.device.type == "cuda"
        assert torch.equal(p.cpu(), pc.detach()) and torch.equal(p, pb), n
    sa, sb = (s.optimizer.state_dict()["state"] for s in (state, back))
    for i in sa:
        for k in sa[i]:
            assert torch.equal(torch.as_tensor(sa[i][k]).cpu(),
                               torch.as_tensor(sb[i][k]).cpu()), k
    lm = restore_params_only(str(tmp_path / "lidf"), build_lidf(cfg, static))
    for k, v in lidf.state_dict().items():
        assert torch.equal(v.cpu(), lm.state_dict()[k]), k


# -- the trainer on the card ---------------------------------------------------

# the stage-1 decode modes: per_ray (K2/K3), global and dense (K6 forward,
# the plain decode recomputed in the backward)
TRAIN_MODES = {"per_ray": {},
               "global": {"pairs_budget_mode": "global",
                          "pairs_budget_per_ray": 8},
               "dense": {"pairs_budget_per_ray": 0}}


def _trainer_cfg(tmp_path, tag, tpu=None, **training):
    # the kernels' decoder widths (K3 takes voxel features of 32-256
    # columns), a narrow trunk; 2 steps of batch 4
    return load_config(overrides={
        "trainer_name": "lidf", "exp_type": "train", "mask_type": "all",
        "base_log_dir": str(tmp_path / tag), "log_name": "t", "seed": 0,
        "dataset": {"type": "synthetic", "synthetic_len": 8,
                    "img_height": 48, "img_width": 64},
        "model": {"rgb_out": 8, "pnet_out": 32, "pnet_gf": 8,
                  "resnet_stages": [1, 1, 1, 1]},
        "grid": {"miss_sample_num": 256, "valid_sample_num": 512},
        "training": {"batch_size": 4, "nepochs": 1, "do_valid": False,
                     "num_workers": 2, "log_interval": 1, **training},
        "tpu": {"max_pairs_per_ray": 12, "compute_dtype": "bfloat16",
                **(tpu or {})}})


@pytest.mark.parametrize("mode", list(TRAIN_MODES))
def test_lidf_train_steps_repeat_bit_for_bit(dev, tmp_path, monkeypatch,
                                             mode):
    """Two stage-1 steps from the same state, batches and draws, twice,
    with cuDNN's deterministic algorithms: the same losses, parameters and
    buffers bit for bit. (The ResNet's bilinear resize back to the input
    size took PyTorch's CUDA backward, which adds with atomics: every
    parameter then differed between the two runs.)"""
    import copy

    from implicit_depth_torch.data.synthetic import synthetic_batch
    from implicit_depth_torch.train.state import TrainState
    from implicit_depth_torch.train.steps import make_lidf_train_step

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    cfg = _trainer_cfg(tmp_path, "steps", TRAIN_MODES[mode])
    model = build_lidf(cfg, build_static(cfg),
                       torch.Generator().manual_seed(0))
    batches = [{k: torch.from_numpy(v) for k, v in
                synthetic_batch(70 + i, 4, 48, 64).items()} for i in range(2)]
    runs = []
    for _ in range(2):
        m = copy.deepcopy(model).to(dev)
        state = TrainState.create(m, cfg.training, steps_per_epoch=10)
        step = make_lidf_train_step(cfg, m, dev)
        gen = torch.Generator(device=dev).manual_seed(3)
        losses = [{k: v.item() for k, v in step(state, b, gen, 0).items()}
                  for b in batches]
        runs.append((losses, {k: v.cpu() for k, v in m.state_dict().items()}))
    (la, sa), (lb, sb) = runs
    assert la == lb
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


@pytest.mark.parametrize("mode", list(TRAIN_MODES))
def test_lidf_train_step_has_no_operation_without_a_deterministic_kernel(
        dev, tmp_path, monkeypatch, mode):
    """No operation of a stage-1 step, in any decode mode, is one for which
    PyTorch has no deterministic CUDA implementation (it warns for each
    under ``use_deterministic_algorithms(True, warn_only=True)``; the
    bilinear resize's backward did)."""
    import warnings

    from implicit_depth_torch.data.synthetic import synthetic_batch
    from implicit_depth_torch.train.state import TrainState
    from implicit_depth_torch.train.steps import make_lidf_train_step

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    cfg = _trainer_cfg(tmp_path, "warn", TRAIN_MODES[mode])
    model = build_lidf(cfg, build_static(cfg)).to(dev)
    state = TrainState.create(model, cfg.training, steps_per_epoch=10)
    step = make_lidf_train_step(cfg, model, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    batch = {k: torch.from_numpy(v) for k, v in
             synthetic_batch(9, 4, 48, 64).items()}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            step(state, batch, gen, 0)
            torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    flagged = sorted({str(w.message).split("\n")[0] for w in caught
                      if "deterministic" in str(w.message)})
    assert not flagged, flagged


def test_trainer_epoch_repeats_bit_for_bit_on_the_card(dev, tmp_path,
                                                        monkeypatch):
    """Two 2-step trainer epochs of batch 4 from the same seed, with cuDNN's
    deterministic algorithms: the same parameters and buffers bit for bit;
    per step K2 1, K3 1, K5 2."""
    from implicit_depth_torch.train.trainer import LIDFTrainer

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    counts = {"ray_decode_save": rd.ray_decode_save,
              "ray_decode_bwd": rd.ray_decode_bwd,
              "segment_max0": segment.segment_max0}
    runs = []
    for tag in ("a", "b"):
        tr = LIDFTrainer(_trainer_cfg(tmp_path, tag), device=dev)
        before = {n: f.launches for n, f in counts.items()}
        means = tr.train_epoch(0)
        torch.cuda.synchronize()
        assert {n: f.launches - before[n] for n, f in counts.items()} == {
            "ray_decode_save": 2, "ray_decode_bwd": 2, "segment_max0": 4}
        assert tr.state.step == 2 and np.isfinite(means["loss_net"])
        runs.append((tr.model.state_dict(), means))
    (a, ma), (b, mb) = runs
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert ma["loss_net"] == mb["loss_net"]


def test_generator_state_saved_on_the_card_restores_on_the_card(dev):
    import json

    from implicit_depth_torch.train.checkpoint import (
        generator_state,
        set_generator_state,
    )
    gen = torch.Generator(device=dev).manual_seed(5)
    torch.rand(1000, generator=gen, device=dev)
    saved = json.loads(json.dumps(generator_state(gen)))
    assert saved["device"] == "cuda"
    want = torch.rand(1000, generator=gen, device=dev)
    other = torch.Generator(device=dev).manual_seed(9)
    set_generator_state(other, saved)
    assert torch.equal(torch.rand(1000, generator=other, device=dev), want)


def test_cpu_saved_mid_epoch_checkpoint_resumes_on_the_card(dev, tmp_path):
    """A CPU run killed after its first step (a mid-epoch checkpoint every
    step) resumes on the card: the restored weights are the CPU's bits,
    the epoch goes on at step 1 with the card's generator reseeded from the
    saved CPU state, and it ends with finite losses."""
    from implicit_depth_torch.train.checkpoint import restore_params_only
    from implicit_depth_torch.train.trainer import LIDFTrainer

    cpu = LIDFTrainer(_trainer_cfg(tmp_path, "r", ckpt_every_steps=1),
                      device="cpu")
    real, calls = cpu.train_step, {"n": 0}

    def dying(*a, **k):
        if calls["n"] >= 1:
            raise RuntimeError("preempted")
        calls["n"] += 1
        return real(*a, **k)

    cpu.train_step = dying
    with pytest.raises(RuntimeError, match="preempted"):
        cpu.run()
    saved = restore_params_only(cpu.ckpt_dir, build_lidf(
        cpu.cfg, build_static(cpu.cfg))).state_dict()

    cfg = _trainer_cfg(tmp_path, "r", ckpt_every_steps=1)
    cfg.resume = "latest_network"
    tr = LIDFTrainer(cfg, device=dev)
    assert tr.start_epoch == 0 and tr._resume_skip_steps == 1
    assert tr.state.step == 1
    for k, v in tr.model.state_dict().items():
        assert v.device.type == dev.type and torch.equal(v.cpu(), saved[k]), k
    tr.run()
    assert tr.state.step == 2
    with open(tr.epoch_log_path) as f:
        import json
        record = json.loads(f.read().splitlines()[-1])
    assert np.isfinite(record["train"]["loss_net"])


# one rank of test_two_gloo_ranks_on_one_card_step_as_one_rank: one f32
# stage-1 step on its block of the global batch, its results saved
_RANK_STEP = r'''
import sys
import torch
from implicit_depth_torch.parallel import mesh

torch.backends.cudnn.enabled = False
torch.backends.cuda.matmul.allow_tf32 = False

device, out_path = sys.argv[1:3]
device = mesh.init_from_env(device, "gloo", timeout_s=120)
sys.path.insert(0, "tests")
from test_torch_port_cuda import _two_rank_case, _one_step

cfg, raw, model = _two_rank_case()
r, world = mesh.rank(), mesh.world()
b = raw["rgb"].shape[0] // world
torch.save(_one_step(cfg, {k: v[r * b:(r + 1) * b] for k, v in raw.items()},
                     model, torch.device(device)), out_path)
mesh.shutdown()
'''


def _run_two_ranks(code, *args, timeout=300):
    """``python -c code *args`` as ranks 0 and 1 of a group on this
    machine; each rank's (return code, output)."""
    import os
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, *(a.format(rank=r) for a in args)],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        env=dict(os.environ, RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r),
                 MASTER_ADDR="localhost", MASTER_PORT=str(port)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, log) for p, log in zip(procs, logs)]


def test_nccl_refuses_two_ranks_on_one_card(dev):
    code = ("from implicit_depth_torch.parallel import mesh\n"
            "mesh.init_from_env('cuda:0', 'nccl', timeout_s=60)")
    for rc, log in _run_two_ranks(code, timeout=120):
        assert rc != 0 and "use --dist_backend gloo" in log, log[-3000:]


def _two_rank_case():
    """The f32 tiny model of test_train_step_card_matches_cpu (the
    kernels' decoder widths) and a batch of 4 synthetic frames."""
    from implicit_depth_torch.data.synthetic import synthetic_batch
    cfg = load_config(overrides={
        "dataset": {"img_height": 48, "img_width": 64},
        "model": {"rgb_out": 8, "pnet_out": 32, "pnet_gf": 8,
                  "resnet_stages": [1, 1, 1, 1]},
        "grid": {"miss_sample_num": 256, "valid_sample_num": 512},
        "tpu": {"max_pairs_per_ray": 12, "compute_dtype": "float32"}})
    raw = {k: torch.from_numpy(v)
           for k, v in synthetic_batch(0, 4, 48, 64).items()}
    g = torch.Generator().manual_seed(1)
    return cfg, raw, randomize_weights_(build_lidf(cfg, build_static(cfg), g),
                                        g)


def _one_step(cfg, batch, model, device):
    """One step (draws from a generator on ``device`` seeded 3): losses,
    gradients, state, all on the CPU."""
    from implicit_depth_torch.train.state import TrainState
    from implicit_depth_torch.train.steps import make_lidf_train_step
    model = model.to(device)
    state = TrainState.create(model, cfg.training, steps_per_epoch=10)
    gen = torch.Generator(device=device).manual_seed(3)
    losses = make_lidf_train_step(cfg, model, device)(state, batch, gen, 10)
    return {"losses": {k: v.cpu() for k, v in losses.items()},
            "grads": {n: p.grad.cpu() for n, p in model.named_parameters()},
            "state": {k: v.cpu() for k, v in model.state_dict().items()}}


def test_two_gloo_ranks_on_one_card_step_as_one_rank(dev, tmp_path,
                                                     monkeypatch):
    """Two ranks of a gloo group, both on this card, take one f32 stage-1
    step on their blocks of a batch of 4 (each through K2, K3, K5): their
    summed losses and every gradient are those of one rank on the whole
    batch, and both ranks hold the same gradients and state, bit for bit.

    The convolutions are PyTorch's own (cuDNN off, in the ranks and here):
    cuDNN picks its algorithms by the batch (2 a rank, 4 here), and the
    backward through the train-mode batch norms amplifies their other
    summation orders far past this bound (scripts/dp_noise_floor.py
    measures how far at full width). Bound: 1e-4 of the norm, plus 1e-7
    for a sum that cancels to ~0 (the probability decoder's last bias,
    ~2e-8), as test_train_step_matches_jax_grad's f32 bound."""
    monkeypatch.setattr(torch.backends.cudnn, "enabled", False)
    for rc, log in _run_two_ranks(_RANK_STEP, "cuda:0",
                                  str(tmp_path / "rank{rank}.pt")):
        assert rc == 0, log[-4000:]
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    cfg, raw, model = _two_rank_case()
    one = _one_step(cfg, raw, model, dev)
    for k, v in one["losses"].items():
        np.testing.assert_allclose(sum(r["losses"][k].item() for r in ranks),
                                   v.item(), rtol=1e-4, atol=1e-6, err_msg=k)
    for name, ref in one["grads"].items():
        assert torch.equal(ranks[0]["grads"][name], ranks[1]["grads"][name])
        diff = (ranks[0]["grads"][name].double() - ref.double()).norm()
        assert diff <= 1e-4 * ref.double().norm() + 1e-7, name
    for k in one["state"]:
        assert torch.equal(ranks[0]["state"][k], ranks[1]["state"][k]), k
