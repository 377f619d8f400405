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


# P = 1000: not a multiple of either type's rows per block (64, 32)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("indexed", [True, False])  # global rows; dense layout
def test_pair_decode_kernel_matches_plain(dev, dtype, indexed):
    rng = np.random.default_rng(19)
    p, n_rays, cv, c_roi, c_dir = 1000, 50, 128, 128, 27
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
    args = (_t(rng.normal(size=(30, cv)), dev, DTYPES[dtype]),
            _t(rng.integers(0, 30, p), dev, torch.int32),
            _t(0.6 * rng.normal(size=(p, 6)), dev),
            _t(rng.normal(size=(n_rays, c_roi + c_dir)), dev, DTYPES[dtype]),
            pw, _t(rng.integers(0, n_rays, p), dev, torch.int32)
            if indexed else None)
    before = pd.pair_decode.launches
    got = pd.pair_decode(*args)
    assert pd.pair_decode.launches == before + 1
    _close(got, pd.pair_decode_plain(*args), ATOL[dtype])


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
    (each C library reports its layout's size)."""
    k1 = cuda.library("ray_decode").idt_ray_decode_smem
    k2all = cuda.library("ray_decode").idt_ray_decode_save_all_smem
    k4 = cuda.library("ief_decode").idt_ief_decode_smem
    k1.argtypes = k2all.argtypes = [cuda.I64] * 3
    k4.argtypes = [cuda.I64] * 2
    k1.restype = k2all.restype = k4.restype = ctypes.c_longlong
    for bf16 in (True, False):
        for kp, crp in ((240, 160), (256, 256), (32, 16)):
            assert k1(kp, crp, bf16) == rd.decode_plan(
                "K1", kp, crp, is_bf16=bf16)["smem"]["total"]
            assert k2all(kp, crp, bf16) == rd.decode_plan(
                "K2all", kp, crp, is_bf16=bf16)["smem"]["total"]
        for kp in (336, 384, 16):
            assert k4(kp, bf16) == rd.decode_plan(
                "K4", kp, is_bf16=bf16)["smem"]["total"]


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
