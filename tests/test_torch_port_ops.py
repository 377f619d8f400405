"""The port's ops and geometry against the JAX package, on the CPU.

Each kernel module's plain version (what a CPU tensor runs) against the JAX
function it replaces, and the plain-torch geometry against its JAX
counterpart, on the same seeded numpy inputs. The CUDA kernels themselves
are tested on the card by ``test_torch_port_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from implicit_depth_tpu.geometry import sampling as jsampling
from implicit_depth_tpu.geometry.camera import compute_xyz as jax_compute_xyz
from implicit_depth_tpu.geometry.rays import ray_dir_map as jax_ray_dir_map
from implicit_depth_tpu.geometry.voxel import make_voxel_grid as jax_grid
from implicit_depth_tpu.geometry.voxel import voxelize_points as jax_voxelize
from implicit_depth_tpu.models.embedder import (
    positional_encoding as jax_posenc,
)
from implicit_depth_tpu.ops.masked import masked_argmax as jax_masked_argmax
from implicit_depth_tpu.ops.masked import masked_softmax as jax_masked_softmax
from implicit_depth_tpu.ops.pallas_ray_decode import xla_ief_rows, xla_ray_decode
from implicit_depth_tpu.ops.pallas_segment import pallas_segment_max0
from implicit_depth_tpu.ops.ray_grid import ray_grid_intersect as jax_rgi
from implicit_depth_tpu.ops.roi_align import roi_window_pool as jax_roi
from implicit_depth_tpu.ops.segment import segment_max0 as jax_segment_max0
from implicit_depth_torch.geometry.camera import compute_xyz
from implicit_depth_torch.geometry.rays import ray_dir_map
from implicit_depth_torch.geometry.sampling import (
    _block_order_perm,
    sample_valid_stratified,
)
from implicit_depth_torch.geometry.voxel import make_voxel_grid, voxelize_points
from implicit_depth_torch.models.embedder import positional_encoding
from implicit_depth_torch.ops import decode_common as common
from implicit_depth_torch.ops import ief_decode as ied
from implicit_depth_torch.ops import ray_decode as rd
from implicit_depth_torch.ops.masked import masked_argmax, masked_softmax
from implicit_depth_torch.ops.ray_grid import ray_grid_intersect
from implicit_depth_torch.ops.roi_align import roi_window_pool
from implicit_depth_torch.ops.segment import segment_max0

torch.set_num_threads(2)
# The first CPU torch.sin of a process that has already run an XLA
# computation sometimes (2-4% of processes under load) computes one intra-op
# thread's share less accurately: up to 1.5e-4 off for arguments of ~100,
# as the positional encodings have. One call before any JAX computation
# runs makes every later call exact (scripts/probe_torch_sin_after_xla.py).
torch.sin(torch.zeros(1 << 16))
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
# f32: one algebra, another summation order; bf16: the layer-1 parts are
# summed in another order before the bf16 rounding of each hidden layer,
# which can move a rounding by one bf16 ulp (~0.4% of a ~1 activation)
ATOL = {"float32": 1e-5, "bfloat16": 2e-2}


def T(a):
    return torch.from_numpy(np.array(a))


def N(t):
    return t.float().numpy()


def _mlp_weights(rng, prefix, in_dim, gf4, w):
    dims = [(in_dim, gf4), (gf4, gf4 // 2), (gf4 // 2, gf4 // 4), (gf4 // 4, 1)]
    for i, (a, b) in enumerate(dims, 1):
        w[f"{prefix}w{i}"] = (rng.normal(size=(a, b)) / np.sqrt(a)).astype(np.float32)
        w[f"{prefix}b{i}"] = (0.1 * rng.normal(size=(b,))).astype(np.float32)


# -- kernel modules: plain version vs JAX ------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ray_decode_plain_matches_xla_ray_decode(dtype):
    rng = np.random.default_rng(1)
    n, kb, cv, cells_n, multires, gf4 = 64, 8, 32, 50, 8, 64
    c_roi, c_dir = 128, 27
    c_embed = cv + c_roi + 6 * (1 + 2 * multires) + c_dir
    w = {"off_enc_w": rng.normal(size=(1, 16)).astype(np.float32),
         "off_enc_b": (0.1 * rng.normal(size=(16,))).astype(np.float32)}
    _mlp_weights(rng, "off_", c_embed + 16, gf4, w)
    _mlp_weights(rng, "prob_", c_embed, gf4, w)
    table = rng.normal(size=(cells_n, cv)).astype(np.float32)
    cells = rng.integers(0, cells_n, (n, kb)).astype(np.int32)
    pos = (0.6 * rng.normal(size=(n, kb, 6))).astype(np.float32)
    ray_feat = rng.normal(size=(n, c_roi + c_dir)).astype(np.float32)
    tdt, jdt = DTYPES[dtype]

    def jax_decode(jdt, cast):
        out = jax.jit(lambda pv, p, rf, ww: xla_ray_decode(
            pv.astype(jdt), p, rf.astype(jdt), ww, kb=kb, multires=multires,
            dtype=jdt))(cast(table[cells.reshape(-1)]), pos.reshape(-1, 6),
                        cast(ray_feat), {k: cast(v) for k, v in w.items()})
        return [np.asarray(o, np.float64) for o in out]

    ref = jax_decode(jdt, lambda a: a)
    pw = rd.prep_ray_decode_weights({k: T(v) for k, v in w.items()}, cv,
                                    c_roi, c_dir, multires, tdt)
    got = rd.ray_decode(T(table).to(tdt), T(cells), T(pos), T(ray_feat).to(tdt),
                        pw)
    assert all(g.shape == (n, kb) for g in got)
    got = [N(g).reshape(-1).astype(np.float64) for g in got]
    if dtype == "float32":
        # both sides against the same decode in f64, so that a failure names
        # the side that drifted; 1e-5 as between the two f32 sides
        with jax.enable_x64(True):
            ref64 = jax_decode(jnp.float64, lambda a: a.astype(np.float64))
        for name, side in (("port", got), ("JAX", ref)):
            for s, r in zip(side, ref64):
                np.testing.assert_allclose(s, r, atol=ATOL[dtype], rtol=0,
                                           err_msg=f"{name} vs f64")
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, atol=ATOL[dtype], rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_operands_from_transposed_views_are_dense(dtype):
    """The training decode splits live parameters, whose (in, out) kernels
    are transposed views of the (out, in) weights; the cast operands the
    kernels read as dense row-major arrays must be contiguous copies with
    the same values."""
    rng = np.random.default_rng(3)
    cv, c_roi, c_dir, multires = 32, 128, 27, 8
    c_embed = cv + c_roi + 6 * (1 + 2 * multires) + c_dir
    w = {"off_enc_w": rng.normal(size=(1, 16)).astype(np.float32),
         "off_enc_b": (0.1 * rng.normal(size=(16,))).astype(np.float32)}
    _mlp_weights(rng, "off_", c_embed + 16, 64, w)
    _mlp_weights(rng, "prob_", c_embed, 64, w)
    views = {k: (T(v.T.copy()).t() if v.ndim == 2 else T(v))
             for k, v in w.items()}
    assert not views["off_w2"].is_contiguous()
    tdt = DTYPES[dtype][0]
    split = rd.split_ray_decode_weights(views, cv, c_roi, c_dir, multires, tdt)
    ops = common.cast_operands(split, rd.FORMAT, tdt)
    want = rd.prep_ray_decode_weights({k: T(v) for k, v in w.items()}, cv,
                                      c_roi, c_dir, multires, tdt)
    for k in rd.FORMAT.operands:
        assert ops[k].is_contiguous(), k
        if k in ("a_vec", "c_vec"):  # products: the layout moves the order
            torch.testing.assert_close(ops[k], want[k], rtol=1e-6, atol=1e-7)
        else:                        # slices, copies and casts: exact
            assert torch.equal(ops[k], want[k]), k


def test_kernel_operands_must_be_contiguous():
    """The kernels index every operand as a dense row-major array: a strided
    view is refused before any pointer reaches them."""
    from implicit_depth_torch.ops import cuda
    a = torch.zeros((4, 3))
    assert len(cuda.ptr_array([a, a[1:]])) == 2
    with pytest.raises(ValueError, match="not contiguous"):
        cuda.ptr_array([a, a.t()])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ief_decode_plain_matches_xla_ief_rows(dtype):
    rng = np.random.default_rng(2)
    n, c_end, c_rc, c_pos, c_dir, gf4 = 96, 32, 128 + 27, 51, 27, 64
    w = {"enc_w": rng.normal(size=(1, 16)).astype(np.float32),
         "enc_b": (0.1 * rng.normal(size=(16,))).astype(np.float32)}
    _mlp_weights(rng, "", c_end + c_rc + c_pos + 16, gf4, w)
    end = rng.normal(size=(n, c_end)).astype(np.float32)
    rc = rng.normal(size=(n, c_rc)).astype(np.float32)
    pe = rng.normal(size=(n, c_pos)).astype(np.float32)
    tdt, jdt = DTYPES[dtype]
    ref = jax.jit(lambda e, r, p, ww: xla_ief_rows(
        e.astype(jdt), r.astype(jdt), p.astype(jdt), ww, c_dir=c_dir,
        dtype=jdt))(end, rc, pe, w)
    pw = ied.prep_ief_weights({k: T(v) for k, v in w.items()}, c_end, c_rc,
                              c_pos, c_dir, tdt)
    got = ied.ief_decode(T(end).to(tdt), T(rc).to(tdt), T(pe).to(tdt), pw)
    assert got.shape == (n,)
    np.testing.assert_allclose(N(got), np.asarray(ref), atol=ATOL[dtype], rtol=0)


@pytest.mark.parametrize("n,c,s,valid_p", [(1000, 64, 729, 0.7),
                                           (777, 128, 100, 1.0),
                                           (64, 32, 8, 0.5)])
def test_segment_max0_plain_matches_jax_and_pallas(n, c, s, valid_p):
    rng = np.random.default_rng(n)
    data = np.abs(rng.normal(size=(n, c))).astype(np.float32)
    ids = rng.integers(0, s, n).astype(np.int32)
    valid = rng.random(n) < valid_p
    got = N(segment_max0(T(data), T(ids), s, T(valid)))
    ref = np.asarray(jax.jit(jax_segment_max0, static_argnums=2)(
        data, ids, s, valid))
    pallas = np.asarray(pallas_segment_max0(
        jnp.asarray(data), jnp.asarray(ids), s, jnp.asarray(valid),
        rows_per_tile=256, interpret=True))
    np.testing.assert_array_equal(got, ref)  # max is exact
    np.testing.assert_array_equal(got, pallas)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segment_max0_any_sign_and_empty_segments(dtype):
    rng = np.random.default_rng(3)
    data = rng.normal(size=(300, 16)).astype(np.float32)
    ids = rng.integers(0, 20, 300).astype(np.int32)  # segments 20..29 empty
    tdt, jdt = DTYPES[dtype]
    got = segment_max0(T(data).to(tdt), T(ids), 30)
    ref = jax.jit(jax_segment_max0, static_argnums=2)(
        jnp.asarray(data, jdt), ids, 30)
    assert got.dtype == tdt
    np.testing.assert_array_equal(N(got), np.asarray(ref, np.float32))
    assert (N(got)[20:] == 0).all()


# -- geometry and non-kernel ops: plain torch vs JAX, f32 --------------------

def _scene(rng, b=2, h=48, w=64):
    depth = rng.uniform(0.6, 1.8, size=(b, h, w)).astype(np.float32)
    depth[rng.random((b, h, w)) < 0.3] = 0.0
    intr = [np.full((b,), v, np.float32) for v in (80.0, 75.0, w / 2, h / 2)]
    return depth, intr


def test_compute_xyz_and_ray_dirs_match():
    depth, (fx, fy, cx, cy) = _scene(np.random.default_rng(4))
    h, w = depth.shape[1:]
    # 1e-6: the same f32 expressions, which XLA may fuse or reassociate
    np.testing.assert_allclose(
        N(compute_xyz(T(depth), T(fx), T(fy), T(cx), T(cy))),
        np.asarray(jax_compute_xyz(depth, fx, fy, cx, cy)), atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        N(ray_dir_map(h, w, T(fx), T(fy), T(cx), T(cy))),
        np.asarray(jax.jit(jax_ray_dir_map, static_argnums=(0, 1))(
            h, w, fx, fy, cx, cy)), atol=1e-6, rtol=0)


def test_voxelize_points_matches():
    rng = np.random.default_rng(5)
    pts = rng.uniform(-1.3, 2.3, size=(2, 500, 3)).astype(np.float32)
    mask = rng.random((2, 500)) < 0.8
    got = voxelize_points(make_voxel_grid(8), T(pts), T(mask))
    ref = jax.jit(lambda p, m: jax_voxelize(jax_grid(8), p, m))(pts, mask)
    for key in ("cell_id", "valid", "occupancy"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]))
    # 1e-6: one f32 subtraction of a cell centre computed in another order
    np.testing.assert_allclose(N(got["rel_coord"]), np.asarray(ref["rel_coord"]),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("k", [12, 25])
def test_ray_grid_intersect_matches(k):
    rng = np.random.default_rng(6)
    depth, (fx, fy, cx, cy) = _scene(rng)
    h, w = depth.shape[1:]
    dirs = np.asarray(jax_ray_dir_map(h, w, fx, fy, cx, cy)).reshape(2, -1, 3)
    occ = rng.random((2, 729)) < 0.3
    mask = rng.random((2, h * w)) < 0.9
    got = ray_grid_intersect(make_voxel_grid(8), T(dirs), T(occ), k, T(mask))
    ref = jax.jit(lambda d, o, m: jax_rgi(jax_grid(8), d, o, k, m))(
        dirs, occ, mask)
    for key in ("cell_id", "valid"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]))
    for key in ("t_enter", "t_exit"):
        # 1e-6: the same f32 plane crossings; XLA may fuse the products
        np.testing.assert_allclose(N(got[key]), np.asarray(ref[key]),
                                   atol=1e-6, rtol=0)


def test_roi_window_pool_matches():
    rng = np.random.default_rng(7)
    feat = rng.normal(size=(2, 48, 64, 8)).astype(np.float32)
    pix = np.stack([rng.integers(0, 64, 300), rng.integers(0, 48, 300)], -1)
    bidx = rng.integers(0, 2, 300)
    pix[:4] = [[0, 0], [63, 47], [3, 44], [60, 2]]  # border windows shift in
    got = roi_window_pool(T(feat), T(pix), T(bidx))
    ref = jax.jit(jax_roi)(feat, pix.astype(np.int32), bidx.astype(np.int32))
    assert got.shape == (300, 2, 2, 8)
    # a 16-term mean in another summation order
    np.testing.assert_allclose(N(got), np.asarray(ref), atol=1e-5, rtol=0)


@pytest.mark.parametrize("multires", [4, 8])
def test_positional_encoding_matches(multires):
    x = np.random.default_rng(8).uniform(-2, 2, size=(100, 3)).astype(np.float32)
    # 1e-6: f32 sin of the same f32 arguments, by two libraries' sin
    np.testing.assert_allclose(
        N(positional_encoding(T(x), multires)),
        np.asarray(jax.jit(jax_posenc, static_argnums=1)(x, multires)),
        atol=1e-6, rtol=0)


def test_masked_softmax_argmax_match():
    rng = np.random.default_rng(9)
    logits = rng.normal(size=(50, 8)).astype(np.float32)
    mask = rng.random((50, 8)) < 0.6
    mask[0] = False  # an all-masked row
    sm = masked_softmax(T(logits), T(mask))
    # 1e-6: f32 exp and sum over 8 slots, in another order
    np.testing.assert_allclose(N(sm), np.asarray(jax_masked_softmax(logits, mask)),
                               atol=1e-6, rtol=0)
    idx, anyv = masked_argmax(sm, T(mask))
    jidx, janyv = jax_masked_argmax(np.asarray(N(sm)), mask)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(anyv.numpy(), np.asarray(janyv))


# -- the valid-point sampler: deterministic cases equal, else stratified -----

def _mask_with(n_valid, h=48, w=64, seed=10):
    rng = np.random.default_rng(seed)
    flat = np.zeros(h * w, bool)
    flat[rng.choice(h * w, n_valid, replace=False)] = True
    return flat.reshape(1, h, w)


@pytest.mark.parametrize("n_valid,n_sample", [(300, 512), (700, 512),
                                              (0, 64)])
def test_sample_valid_stratified_deterministic_cases_equal(n_valid, n_sample):
    """Fewer valid pixels than samples (cycle through them) or a stride of 1
    (cnt < 2n: no jitter) -> the same indices as JAX."""
    mask = _mask_with(n_valid)
    idx, slot, cnt = sample_valid_stratified(T(mask), n_sample,
                                             torch.Generator().manual_seed(0))
    jidx, jslot, jcnt = jax.jit(jsampling.sample_valid_stratified,
                                static_argnums=1)(mask, n_sample,
                                                  jax.random.key(0))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))


def test_sample_valid_stratified_jittered_case_stays_in_stride():
    mask = _mask_with(2000)
    n = 256
    idx, slot, cnt = sample_valid_stratified(T(mask), n,
                                             torch.Generator().manual_seed(1))
    idx = idx.numpy()[0]
    assert slot.all() and int(cnt[0]) == 2000
    assert mask.reshape(-1)[idx].all()  # every index is a valid pixel
    # its rank among the valid pixels in block-scan order lies in its stride
    perm = _block_order_perm(48, 64, 8, 8)
    block_rank = np.cumsum(mask.reshape(-1)[perm]) - 1
    rank_of_pixel = np.empty(48 * 64, np.int64)
    rank_of_pixel[perm] = block_rank
    i = np.arange(n)
    stride = 2000 // n
    lo = i * 2000 // n
    r = rank_of_pixel[idx]
    assert ((r >= lo) & (r < lo + stride)).all()
