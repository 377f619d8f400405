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


def _pair_case(rng, dev, dtype, p, n_rays, indexed):
    """K6's operands at the default widths: P rows over ``n_rays`` rays (the
    dense layout when not ``indexed``: P / n_rays consecutive rows a ray)."""
    cv, c_roi, c_dir = 128, 128, 27
    c_embed = cv + c_roi + 102 + c_dir
    w = {"off_enc_w": rng.normal(size=(1, 16)),
         "off_enc_b": 0.1 * rng.normal(size=(16,))}
    _mlp_weights(rng, "off_", c_embed + 16, 256, w)
    _mlp_weights(rng, "prob_", c_embed, 256, w)
    for pre, bias in (("off_", 0.25), ("prob_", 0.5)):  # outputs in (0, 1)
        w[f"{pre}w4"] *= 0.25
        w[f"{pre}b4"] = np.full((1,), bias)
    pw = pd.prep_pair_decode_weights({k: _t(v, dev) for k, v in w.items()},
                                     cv, c_roi, c_dir, 8, DTYPES[dtype])
    return (_t(rng.normal(size=(30, cv)), dev, DTYPES[dtype]),
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
        plan = rd.decode_plan("K6", 400, n=p, sm_count=cuda.sm_count(dev))
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
    pw = rd.prep_ief_weights({k: _t(v, dev) for k, v in w.items()}, c_end,
                             c_rc, c_pos, c_dir, DTYPES[dtype])
    args = tuple(_t(rng.normal(size=(n, c)), dev, DTYPES[dtype])
                 for c in (c_end, c_rc, c_pos))
    before = rd.ief_decode.launches
    _close(rd.ief_decode(*args, pw), rd.ief_decode_plain(*args, pw), ATOL[dtype])
    assert rd.ief_decode.launches == before + 1


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
                 n_table=30):
    c_embed = cv + c_roi + 102 + c_dir
    w = {"off_enc_w": rng.normal(size=(1, 16)),
         "off_enc_b": 0.1 * rng.normal(size=(16,))}
    _mlp_weights(rng, "off_", c_embed + 16, 256, w)
    _mlp_weights(rng, "prob_", c_embed, 256, w)
    for pre, bias in (("off_", 0.25), ("prob_", 0.5)):  # outputs in (0, 1)
        w[f"{pre}w4"] *= 0.25
        w[f"{pre}b4"] = np.full((1,), bias)
    w32 = rd.split_ray_decode_weights({k: _t(v, dev) for k, v in w.items()},
                                      cv, c_roi, c_dir, 8, DTYPES[dtype])
    args = (_t(rng.normal(size=(n_table, cv)), dev),
            _t(rng.integers(0, n_table, (n, 8)), dev, torch.int32),
            _t(0.6 * rng.normal(size=(n, 8, 6)), dev),
            _t(rng.normal(size=(n, c_roi + c_dir)), dev, DTYPES[dtype]))
    cot = (_t(rng.normal(size=(n, 8)), dev), _t(rng.normal(size=(n, 8)), dev))
    return w32, args, cot


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ray_decode_save_kernel_matches_plain(dev, dtype):
    rng = np.random.default_rng(15)
    w32, args, _ = _decode_case(rng, dev, dtype)
    w = rd.cast_ray_decode_operands(w32, DTYPES[dtype])
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


def _ief_case(rng, dev, dtype, n):
    c_end, c_rc, c_pos, c_dir = 128, 155, 51, 27
    w = {"enc_w": rng.normal(size=(1, 16)), "enc_b": 0.1 * rng.normal(size=(16,))}
    _mlp_weights(rng, "", c_end + c_rc + c_pos + 16, 256, w)
    pw = rd.prep_ief_weights({k: _t(v, dev) for k, v in w.items()}, c_end,
                             c_rc, c_pos, c_dir, DTYPES[dtype])
    return tuple(_t(rng.normal(size=(n, c)), dev, DTYPES[dtype])
                 for c in (c_end, c_rc, c_pos)), pw


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
            plan = rd.decode_plan(kernel, 240, 160, n=rows,
                                  sm_count=cuda.sm_count(dev))
            assert plan["tiles"] > plan["blocks"]
    rng = np.random.default_rng(23)
    w32, args, _ = _decode_case(rng, dev, dtype, n=n)
    w = rd.cast_ray_decode_operands(w32, DTYPES[dtype])
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
    got = rd.ief_decode(*rows, pw)
    assert torch.equal(got, rd.ief_decode(*rows, pw)) and got.shape == (8 * n,)
    _close(got, rd.ief_decode_plain(*rows, pw), ATOL[dtype])


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
    w = rd.cast_ray_decode_operands(w32, DTYPES[dtype])
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
    """ops/ray_decode.py::decode_plan's shared memory is the kernels' own
    (each C library reports its layout's size): K1, K2 'all', K4, K6."""
    k1 = cuda.library("ray_decode").idt_ray_decode_smem
    k2all = cuda.library("ray_decode").idt_ray_decode_save_all_smem
    k4 = cuda.library("ief_decode").idt_ief_decode_smem
    k6 = cuda.library("pair_decode").idt_pair_decode_smem
    k1.argtypes = k2all.argtypes = [cuda.I64] * 3
    k4.argtypes = k6.argtypes = [cuda.I64] * 2
    k1.restype = k2all.restype = k4.restype = k6.restype = ctypes.c_longlong
    for bf16 in (True, False):
        for kp, crp in ((240, 160), (256, 256), (32, 16)):
            assert k1(kp, crp, bf16) == rd.decode_plan(
                "K1", kp, crp, is_bf16=bf16)["smem"]["total"]
            assert k2all(kp, crp, bf16) == rd.decode_plan(
                "K2all", kp, crp, is_bf16=bf16)["smem"]["total"]
        for kp in (336, 384, 16):
            assert k4(kp, bf16) == rd.decode_plan(
                "K4", kp, is_bf16=bf16)["smem"]["total"]
        for kp in (400, rd.MAX_KP["K6"], 16):
            assert k6(kp, bf16) == rd.decode_plan(
                "K6", kp, is_bf16=bf16)["smem"]["total"]


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
    w = rd.cast_ray_decode_operands(w32, DTYPES[dtype])
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
    w = rd.cast_ray_decode_operands(w32, DTYPES[dtype])
    saves = _k2_saves(args, w, saves_of)
    first = rd.ray_decode_bwd(*args, w, saves, *cot)
    for _ in range(2):
        again = rd.ray_decode_bwd(*args, w, saves, *cot)
        assert torch.equal(again[0], first[0])
        assert torch.equal(again[1], first[1])


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
def test_pair_decode_modes_serve_on_the_card_and_refuse_to_train(dev, tpu):
    """The dense and global modes: eval frames launch K6 once and K1 never
    and agree with the CPU (plain version) in f32, every valid pixel a
    point; train mode raises (K6 has no backward, as the JAX kernel has
    none)."""
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
    from implicit_depth_torch.train.state import TrainState
    from implicit_depth_torch.train.steps import make_lidf_train_step
    tcfg = mode_cfg(512)
    model = randomize_weights_(build_lidf(tcfg, build_static(tcfg), g), g)
    state = TrainState.create(model, tcfg.training, steps_per_epoch=10)
    batch = {k: torch.from_numpy(v)
             for k, v in synthetic_batch(0, 1, 48, 64).items()}
    with pytest.raises(NotImplementedError, match="no backward"):
        make_lidf_train_step(tcfg, model, dev)(state, batch, None, 0)


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
    w32 = rd.split_ief_weights(params, c_end, c_rc, c_pos, c_dir, dtype)
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
    before = rd.ief_decode.launches
    out = rd.ief_decode_train(*rows, w32, dt)
    assert rd.ief_decode.launches == before + 1
    with torch.no_grad():
        k4 = rd.ief_decode(*rows, rd.prep_ief_weights(
            params, 128, 155, 51, 27, dt))
    assert torch.equal(out, k4)
    g = torch.randn(out.shape, generator=torch.Generator(dev).manual_seed(1),
                    device=dev)
    got = _ief_grads(out, rows, params, g)
    plain = rd.ief_decode_plain(*rows, rd._ief_train_operands(w32, dt),
                                dtype=dt)
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
    names = ("ray_decode", "ray_decode_save", "ray_decode_bwd", "ief_decode")
    counts = {n: getattr(rd, n) for n in names}
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
    a_vec, c_vec = rd._rank1(w["enc_w"], w["enc_b"], w1[o4:], dtype)
    out = {"w1": rd._pad_rows(torch.cat([w1[:o1], w1[o1:o2], w1[o3:o4],
                                         w1[o2:o3]], 0), kp).to(dtype
                                                                ).contiguous(),
           "b1": w["b1"].float(), "a_vec": a_vec, "c_vec": c_vec}
    out.update({"w2": w["w2"].to(dtype).contiguous(),
                "b2": rd._q(w["b2"], dtype),
                "w3": w["w3"].to(dtype).contiguous(),
                "b3": rd._q(w["b3"], dtype),
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
    for k in rd._K4_WEIGHTS:
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
