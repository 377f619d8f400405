"""The port's stage-1 training slice against the JAX package, on the CPU.

The window sampler and the training inputs, ResNet train mode, the K5
gradient, the training decode (K2's saves, K3's gradients, both through the
plain versions a CPU tensor takes) against the JAX Pallas kernels in
interpret mode, the loss functions, the optimizers, and the whole train and
eval steps against ``jax.grad`` of the JAX ``loss_fn``. Every case feeds
both frameworks the same seeded numpy inputs and weights; the random draws
(valid points, window starts) are JAX's, passed in.

Tolerances: f32 compares one algebra summed in another order (1e-4 relative
to the largest value of a tensor, as each case states); bf16 compares two
frameworks that round at other places, by the relative norm of the
difference (2e-2 per tensor; the whole train step's parameter gradients
miss that, and are held per group of parameters: ``BF16_GRAD_LIMITS``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from implicit_depth_tpu.builder import build_lidf as jax_build_lidf
from implicit_depth_tpu.builder import build_static as jax_build_static
from implicit_depth_tpu.config import load_config as jax_load_config
from implicit_depth_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from implicit_depth_tpu.geometry import normals as jnormals
from implicit_depth_tpu.geometry import sampling as jsampling
from implicit_depth_tpu.models import lidf as jlidf
from implicit_depth_tpu.models.resnet import ResNet34_8s as JaxResNet
from implicit_depth_tpu.ops import masked as jmasked
from implicit_depth_tpu.ops.pallas_ray_decode import (
    _fused_fwd_impl,
    fused_ray_decode_table,
    pack_pair_pos,
)
from implicit_depth_tpu.ops.segment import segment_max0 as jax_segment_max0
from implicit_depth_tpu.train import state as jstate
from implicit_depth_tpu.train import steps as jsteps
from implicit_depth_torch.builder import build_lidf, build_static
from implicit_depth_torch.config import load_config
from implicit_depth_torch.data.synthetic import synthetic_batch
from implicit_depth_torch.geometry import normals
from implicit_depth_torch.geometry.sampling import sample_masked_window
from implicit_depth_torch.models import lidf
from implicit_depth_torch.models.resnet import ResNet34_8s
from implicit_depth_torch.ops import decode_common as common
from implicit_depth_torch.ops import masked
from implicit_depth_torch.ops import ray_decode as rd
from implicit_depth_torch.ops.segment import segment_max0_grad, segment_max0_plain
from implicit_depth_torch.train.state import TrainState, make_optimizer, step_lr
from implicit_depth_torch.train.steps import make_lidf_eval_step, make_lidf_train_step
from implicit_depth_torch.weights import (
    lidf_from_jax,
    lidf_grads_from_jax,
    load_resnet,
    resnet_batch_stats,
)

torch.set_num_threads(2)
# a first torch.sin before any JAX computation (see test_torch_port_ops.py)
torch.sin(torch.zeros(1 << 16))
H, W = 48, 64


def T(a):
    return torch.from_numpy(np.array(a))


def N(t):
    return t.detach().float().numpy()


def assert_rel_max(got, ref, rtol, what="", atol=0.0):
    """max |got - ref| <= rtol · max |ref| + atol (f32: one algebra in
    another summation order, relative to the tensor's scale)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = np.abs(ref).max()
    err = np.abs(got - ref).max()
    assert err <= rtol * scale + atol, \
        f"{what}: max error {err:.3g} of scale {scale:.3g}"


def assert_rel_norm(got, ref, rtol, what=""):
    """||got - ref|| <= rtol · ||ref|| (bf16 rounds at other places in the
    two frameworks)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-12)
    assert err <= rtol, f"{what}: relative norm error {err:.3g}"


def tiny_overrides(dtype):
    # the tiny_overrides of test_torch_port_slice.py, with the training
    # batch's masks driving the rays
    return {
        "mask_type": "all",
        "dataset": {"img_height": H, "img_width": W},
        "model": {"rgb_out": 8, "pnet_out": 16, "pnet_gf": 8, "imnet_gf": 8,
                  "resnet_stages": [1, 1, 1, 1]},
        "grid": {"res": 8, "miss_sample_num": 256, "valid_sample_num": 512},
        "tpu": {"max_pairs_per_ray": 12, "pairs_budget_per_ray": 8,
                "use_pallas_decode": False, "compute_dtype": dtype},
    }


def randomize(tree, rng):
    """Every leaf redrawn at O(1) activation scale (as the randomize of
    test_torch_port_slice.py): slot near-ties stay out of the comparison."""
    if isinstance(tree, dict):
        return {k: (randomize(v, rng) if isinstance(v, dict)
                    else _leaf(k, np.asarray(v), rng)) for k, v in tree.items()}
    raise TypeError(type(tree))


def _leaf(name, a, rng):
    if name == "kernel":
        fan_in = int(np.prod(a.shape[:-1]))
        return (rng.normal(size=a.shape) / np.sqrt(fan_in)).astype(np.float32)
    if name == "scale":
        return (1.0 + 0.1 * rng.normal(size=a.shape)).astype(np.float32)
    if name == "var":
        return (0.5 + 0.5 * np.abs(rng.normal(size=a.shape))).astype(np.float32)
    return (0.1 * rng.normal(size=a.shape)).astype(np.float32)


# -- window sampler and training inputs ---------------------------------------

@pytest.mark.parametrize("n_sample", [40, 300])
def test_sample_masked_window_matches_with_the_jax_start(n_sample):
    rng = np.random.default_rng(20)
    mask = rng.random((3, 600)) < np.array([[0.5], [0.02], [0.0]])
    jidx, jslot, jcnt, jstart = jax.jit(
        jsampling.sample_masked_window, static_argnums=1)(
        mask, n_sample, jax.random.key(3))
    idx, slot, cnt, start = sample_masked_window(
        T(mask), n_sample, start=T(np.asarray(jstart)))
    np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
    np.testing.assert_array_equal(start.numpy(), np.asarray(jstart))
    ok = np.asarray(jslot)
    np.testing.assert_array_equal(idx.numpy()[ok], np.asarray(jidx)[ok])


def test_sample_masked_window_draws_a_window_of_the_mask():
    rng = np.random.default_rng(21)
    mask = rng.random((2, 900)) < 0.4
    g = torch.Generator().manual_seed(0)
    idx, slot, cnt, start = sample_masked_window(T(mask), 100, g)
    for b in range(2):
        nz = np.flatnonzero(mask[b])
        s = int(start[b])
        assert 0 <= s <= len(nz) - 100 and slot[b].all()
        np.testing.assert_array_equal(idx[b].numpy(), nz[s:s + 100])


def _jax_train_inputs(jstatic, raw, key=0):
    batch = {k: jnp.asarray(v) for k, v in raw.items()}
    return jax.jit(lambda b, k: jlidf.prepare_inputs(
        jstatic, b, k, train=True))(batch, jax.random.key(key))


def test_synthetic_batch_copy_is_the_same():
    a, b = synthetic_batch(4, 2, H, W), jax_synthetic_batch(4, 2, H, W)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_prepare_inputs_train_matches():
    cfg = load_config(overrides=tiny_overrides("float32"))
    jstatic = jax_build_static(jax_load_config(overrides=tiny_overrides(
        "float32")))
    raw = synthetic_batch(3, 2, H, W)
    jin = _jax_train_inputs(jstatic, raw)
    inp = lidf.prepare_inputs(
        build_static(cfg), {k: T(v) for k, v in raw.items()}, train=True,
        valid_idx=T(jin["valid_idx"]), miss_start=T(jin["miss_start"]))
    assert set(inp) == set(jin)
    slot = np.asarray(jin["miss_slot"])
    assert slot.any() and (~slot).any()  # some padded ray slots
    for k, v in jin.items():
        j, p = np.asarray(v), inp[k].numpy()
        if k == "miss_idx":  # garbage past the window
            j, p = j[slot], p[slot]
        if j.dtype.kind == "f":
            # 1e-5: the same f32 geometry (plane crossings)
            np.testing.assert_allclose(p, j, atol=1e-5, rtol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(p, j, err_msg=k)


# -- ResNet train mode ----------------------------------------------------------

def test_resnet_train_mode_matches_flax():
    rng = np.random.default_rng(22)
    x = rng.normal(size=(2, 40, 48, 3)).astype(np.float32)
    jm = JaxResNet(out_ch=8, stage_sizes=(1, 1, 1, 1))
    var = randomize(jax.device_get(jm.init(jax.random.key(0), x)), rng)
    jout, mut = jax.jit(lambda v, a: jm.apply(
        v, a, True, mutable=["batch_stats"]))(var, x)
    m = ResNet34_8s(out_ch=8, stage_sizes=(1, 1, 1, 1))
    load_resnet(m, var["params"], var["batch_stats"])
    out = m.train()(T(x))
    # 1e-4 of the largest value: f32 convolutions and batch moments summed
    # in another order through five BatchNorms in train mode
    assert_rel_max(N(out), jout, 1e-4, "output")
    got = resnet_batch_stats(m)
    want = jax.device_get(mut["batch_stats"])
    for path in ("bn1", "layer1_0/bn2", "layer3_0/down_bn", "layer4_0/bn1"):
        g, w = got, want
        for key in path.split("/"):
            g, w = g[key], w[key]
        for s in ("mean", "var"):
            assert_rel_max(g[s], w[s], 1e-4, f"{path}/{s}")
    # eval mode reads the running statistics and leaves them alone
    before = resnet_batch_stats(m)["bn1"]["var"].copy()
    m.eval()(T(x))
    np.testing.assert_array_equal(resnet_batch_stats(m)["bn1"]["var"], before)


# -- the K5 gradient ---------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segment_max0_grad_shares_ties_as_jax(dtype):
    rng = np.random.default_rng(23)
    n, c, s = 400, 8, 40            # segments 30..39 stay empty
    data = np.maximum(rng.normal(size=(n, c)), 0).astype(np.float32)
    data[::5] = data[1::5]          # more ties, inside and across segments
    data[10:13, 0] = 2.5            # three rows tie at one maximum
    ids = rng.integers(0, 30, n).astype(np.int32)
    ids[10:13] = 7
    valid = rng.random(n) < 0.8
    valid[10:13] = True
    valid[ids == 29] = False        # a segment with only invalid rows
    cot = rng.normal(size=(s, c)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jgrad = np.asarray(jax.jit(jax.grad(lambda d: jnp.sum(
        jax_segment_max0(d, ids, s, valid).astype(jnp.float32) * cot)))(
        jnp.asarray(data, jdt)), np.float32)
    assert np.isclose(jgrad[10:13, 0], jgrad[10, 0]).all()  # shared

    d = T(data).to(tdt).requires_grad_()
    out = segment_max0_plain(d, T(ids), s, T(valid))
    (out.float() * T(cot)).sum().backward()
    # the CUDA path's backward, on the plain forward's output
    kgrad = segment_max0_grad(d.detach(), T(ids), T(valid), out.detach(),
                              T(cot))
    # a share is g / count, one rounding in either framework
    for got in (N(d.grad), N(kgrad)):
        np.testing.assert_allclose(got, jgrad, rtol=1e-6 if tdt ==
                                   torch.float32 else 1e-2, atol=0)
    assert (N(kgrad)[~valid] == 0).all()


# -- the training decode: K2's saves and K3's gradients ------------------------

KB, CV, C_ROI, C_DIR, GF4, MULTIRES = 8, 16, 32, 27, 32, 8
N_IMG, RAYS_PER_IMG, CELLS, TILE = 2, 32, 40, 16


def _decode_case(seed):
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
        # outputs inside (0, 1), away from the soft clamp's kinks (as
        # builder.randomize_weights_ sets the last layer)
        w[f"{pre}w4"] *= 0.25
        w[f"{pre}b4"] = np.full((1,), 0.25 if pre == "off_" else 0.5,
                                np.float32)
    n = N_IMG * RAYS_PER_IMG
    local = rng.integers(0, CELLS, (n, KB)).astype(np.int32)
    img = np.arange(n)[:, None] // RAYS_PER_IMG
    return dict(
        w=w, local=local, cells=(local + img * CELLS).astype(np.int32),
        table=rng.normal(size=(N_IMG * CELLS, CV)).astype(np.float32),
        pos=(0.6 * rng.normal(size=(n, KB, 6))).astype(np.float32),
        ray_feat=rng.normal(size=(n, C_ROI + C_DIR)).astype(np.float32),
        g_off=rng.normal(size=(n, KB)).astype(np.float32),
        g_logit=rng.normal(size=(n, KB)).astype(np.float32))


def _jax_table_args(case, jdt):
    return (jnp.asarray(case["local"]),
            pack_pair_pos(jnp.asarray(case["pos"][..., :3]),
                          jnp.asarray(case["pos"][..., 3:])),
            jnp.asarray(case["ray_feat"], jdt),
            jnp.asarray(case["table"], jdt))


def _port_w32(case, dtype, requires_grad=False):
    w = {k: T(v).requires_grad_(requires_grad) for k, v in case["w"].items()}
    return w, rd.split_ray_decode_weights(w, CV, C_ROI, C_DIR, MULTIRES, dtype)


DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ray_decode_save_matches_the_l1_saves(dtype):
    case = _decode_case(24)
    tdt, jdt = DTYPES[dtype]
    cells, pos, rf, table = _jax_table_args(case, jdt)
    joff, jlogit, jsaves = _fused_fwd_impl(
        None, pos, rf, {k: jnp.asarray(v) for k, v in case["w"].items()}, KB,
        MULTIRES, 2, 0.001, False, jdt, TILE, True, cell_ids=cells,
        vox_table=table, tiles_per_image=RAYS_PER_IMG // TILE,
        save_mode="l1", train=True)
    _, w32 = _port_w32(case, tdt)
    off, logit, saves = rd.ray_decode_save(
        T(case["table"]).to(tdt), T(case["cells"]), T(case["pos"]),
        T(case["ray_feat"]).to(tdt),
        common.cast_operands(w32, rd.FORMAT, tdt))
    check = assert_rel_max if dtype == "float32" else assert_rel_norm
    # f32 1e-5 of the scale; bf16 a relative norm of 1e-2 (a one-ulp move
    # of a rounded pre-activation)
    tol = 1e-5 if dtype == "float32" else 1e-2
    check(N(off), joff, tol, "offset")
    check(N(logit), jlogit, tol, "logit")
    for name, got, want in zip(("e1", "z1p", "trig"), saves, jsaves):
        assert got.dtype == tdt
        check(N(got), np.asarray(want, np.float32), tol, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ray_decode_save_all_matches_the_full_saves(dtype):
    """``decode_bwd: kernel_save_all``'s forward: every save of the plain
    ``ray_decode_plain(saves='all')`` (through ``ray_decode_save_all`` on
    the CPU) against the JAX kernel's ``save_mode='all'``, by name, at the
    tolerances of the l1 saves."""
    case = _decode_case(28)
    tdt, jdt = DTYPES[dtype]
    cells, pos, rf, table = _jax_table_args(case, jdt)
    joff, jlogit, jsaves = _fused_fwd_impl(
        None, pos, rf, {k: jnp.asarray(v) for k, v in case["w"].items()}, KB,
        MULTIRES, 2, 0.001, False, jdt, TILE, True, cell_ids=cells,
        vox_table=table, tiles_per_image=RAYS_PER_IMG // TILE,
        save_mode="all", train=True)
    _, w32 = _port_w32(case, tdt)
    off, logit, saves = rd.ray_decode_save_all(
        T(case["table"]).to(tdt), T(case["cells"]), T(case["pos"]),
        T(case["ray_feat"]).to(tdt),
        common.cast_operands(w32, rd.FORMAT, tdt))
    names = rd.save_names(2, "all")
    assert len(names) == len(saves) == len(jsaves) == 13
    check = assert_rel_max if dtype == "float32" else assert_rel_norm
    tol = 1e-5 if dtype == "float32" else 1e-2
    check(N(off), joff, tol, "offset")
    check(N(logit), jlogit, tol, "logit")
    for name, got, want in zip(names, saves, jsaves):
        # the offsets and the logit before the squash stay f32
        f32 = name.startswith("off") or name == "logit"
        assert got.dtype == (torch.float32 if f32 else tdt), name
        check(N(got), np.asarray(want, np.float32), tol, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_sigmoid", [False, True])
def test_ray_decode_bwd_plain_from_full_saves_matches_jax(dtype, use_sigmoid):
    """``ray_decode_bwd_plain`` from the full saves (K3 'all''s function)
    against ``jax.vjp`` of ``fused_ray_decode_table(bwd_impl=
    'kernel_save_all')`` in interpret mode. f32: 1e-4 of each gradient's
    scale. bf16: the JAX kernel starts from its bf16 saves and rounds each
    cotangent, so it lies a few percent from JAX's own 'xla' gradient; the
    port must lie no farther from it than 1.25 times that, plus 1e-2."""
    case = _decode_case(29)
    tdt, jdt = DTYPES[dtype]
    cells, pos, rf, table = _jax_table_args(case, jdt)
    jw = {k: jnp.asarray(v) for k, v in case["w"].items()}

    def jgrads(bwd_impl):
        def f(rf_, tb, ws):
            return fused_ray_decode_table(
                cells, pos, rf_, tb, ws, KB, RAYS_PER_IMG // TILE, MULTIRES,
                2, 0.001, use_sigmoid, jdt, TILE, True, bwd_impl)
        _, vjp = jax.vjp(f, rf, table, jw)
        d_rf, d_tab, d_w = vjp((jnp.asarray(case["g_off"]),
                                jnp.asarray(case["g_logit"])))
        return {"d_table": d_tab, "d_ray_feat": d_rf, **d_w}

    want = jgrads("kernel_save_all")
    _, w32 = _port_w32(case, tdt)
    w = common.cast_operands(w32, rd.FORMAT, tdt)
    args = (T(case["table"]).to(tdt), T(case["cells"]), T(case["pos"]),
            T(case["ray_feat"]).to(tdt))
    kw = dict(use_sigmoid=use_sigmoid)
    saves = rd.ray_decode_plain(*args, w, **kw, saves="all")[2]
    d_tab, d_rf, d_split = rd.ray_decode_bwd_plain(
        *args, w, T(case["g_off"]), T(case["g_logit"]), **kw, dtype=tdt,
        saved=saves)
    # the split operands' gradients laid back onto the parameters, as
    # training does through split_ray_decode_weights
    wp, w32p = _port_w32(case, tdt, requires_grad=True)
    torch.autograd.backward([w32p[k] for k in rd.FORMAT.operands],
                            [d_split[k] for k in rd.FORMAT.operands])
    got = {"d_table": N(d_tab), "d_ray_feat": N(d_rf),
           **{k: N(v.grad) for k, v in wp.items()}}
    xla = jgrads("xla") if dtype == "bfloat16" else None
    for k, g in got.items():
        ref = np.asarray(want[k], np.float32)
        if dtype == "float32":
            assert_rel_max(g, ref, 1e-4, k)
        else:
            x = np.asarray(xla[k], np.float32)
            own = np.linalg.norm(x - ref) / max(np.linalg.norm(ref), 1e-12)
            assert_rel_norm(g, ref, 1.25 * own + 1e-2, k)


@pytest.mark.parametrize("dtype,use_sigmoid,bwd_impl", [
    ("float32", False, "kernel_save"), ("float32", True, "kernel_save"),
    ("bfloat16", False, "kernel_save"), ("bfloat16", True, "kernel_save"),
    ("float32", False, "xla"), ("bfloat16", False, "xla"),
    ("float32", False, "kernel_save_all"), ("bfloat16", True,
                                            "kernel_save_all")])
def test_ray_decode_train_grads_match_jax(dtype, use_sigmoid, bwd_impl):
    case = _decode_case(25)
    tdt, jdt = DTYPES[dtype]
    cells, pos, rf, table = _jax_table_args(case, jdt)

    def jloss(rf_, tb, ws):
        off, logit = fused_ray_decode_table(
            cells, pos, rf_, tb, ws, KB, RAYS_PER_IMG // TILE, MULTIRES, 2,
            0.001, use_sigmoid, jdt, TILE, True, bwd_impl)
        return jnp.sum(off * case["g_off"] + logit * case["g_logit"])

    jw = {k: jnp.asarray(v) for k, v in case["w"].items()}
    jd_rf, jd_tab, jd_w = jax.grad(jloss, argnums=(0, 1, 2))(rf, table, jw)
    bf16_kernel = dtype == "bfloat16" and bwd_impl.startswith("kernel_save")
    if bf16_kernel:
        # the JAX kernel recomputes from its bf16 saves of e1 and z1p (and
        # with 'kernel_save_all' reads every activation from them): its
        # gradients lie a few percent from the exact gradient of the bf16
        # forward ('xla', which plain autograd computes). The port must lie
        # no farther from it than JAX's own 'xla' does.
        mode, bwd_impl = bwd_impl, "xla"
        jx_rf, jx_tab, jx_w = jax.grad(jloss, argnums=(0, 1, 2))(rf, table, jw)
        bwd_impl = mode

    w, w32 = _port_w32(case, tdt, requires_grad=True)
    tab = T(case["table"]).requires_grad_()
    ray_feat = T(case["ray_feat"]).to(tdt).requires_grad_()
    off, logit = rd.ray_decode_train(tab, T(case["cells"]), T(case["pos"]),
                                     ray_feat, w32, tdt,
                                     use_sigmoid=use_sigmoid,
                                     decode_bwd=bwd_impl)
    (off * T(case["g_off"]) + logit * T(case["g_logit"])).sum().backward()
    got = {"d_table": N(tab.grad), "d_ray_feat": N(ray_feat.grad),
           **{k: N(v.grad) for k, v in w.items()}}
    want = {"d_table": jd_tab, "d_ray_feat": jd_rf, **jd_w}
    for k, g in got.items():
        ref = np.asarray(want[k], np.float32)
        if dtype == "float32":  # 1e-4 of each gradient's scale
            assert_rel_max(g, ref, 1e-4, k)
        elif bf16_kernel:
            xla = np.asarray({"d_table": jx_tab, "d_ray_feat": jx_rf,
                              **jx_w}[k], np.float32)
            own = np.linalg.norm(xla - ref) / max(np.linalg.norm(ref), 1e-12)
            assert_rel_norm(g, ref, 1.25 * own + 1e-2, k)
        else:  # 2e-2: the JAX 'xla' backward rounds each cotangent at its
            # casts to bf16, plain autograd with straight-through casts not
            assert_rel_norm(g, ref, 2e-2, k)


def test_ray_decode_bwd_plain_is_the_train_gradient():
    case = _decode_case(26)
    w, w32 = _port_w32(case, torch.float32, requires_grad=True)
    args = (T(case["table"]).requires_grad_(), T(case["cells"]),
            T(case["pos"]), T(case["ray_feat"]).requires_grad_())
    off, logit = rd.ray_decode_train(*args, w32, torch.float32)
    grads = torch.autograd.grad(
        (off, logit),
        [args[0], args[3], *(w32[k] for k in rd.FORMAT.operands)],
        (T(case["g_off"]), T(case["g_logit"])))
    d_tab, d_rf, d_w = rd.ray_decode_bwd_plain(
        *args, {k: v.detach() for k, v in w32.items()
                if k != "dims"} | {"dims": w32["dims"]},
        T(case["g_off"]), T(case["g_logit"]), dtype=torch.float32)
    np.testing.assert_array_equal(N(d_tab), N(grads[0]))
    np.testing.assert_array_equal(N(d_rf), N(grads[1]))
    for k, g in zip(rd.FORMAT.operands, grads[2:]):
        np.testing.assert_array_equal(N(d_w[k]), N(g), err_msg=k)


def test_ray_decode_train_modes_on_the_cpu_and_bad_mode():
    case = _decode_case(27)
    _, w32 = _port_w32(case, torch.float32)
    args = (T(case["table"]), T(case["cells"]), T(case["pos"]),
            T(case["ray_feat"]))
    outs = [rd.ray_decode_train(*args, w32, torch.float32, decode_bwd=m)
            for m in rd.DECODE_BWD_MODES]
    for o in outs[1:]:  # every mode is the plain path on the CPU
        np.testing.assert_array_equal(N(o[0]), N(outs[0][0]))
    with pytest.raises(ValueError):
        rd.ray_decode_train(*args, w32, torch.float32, decode_bwd="nope")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("decode_bwd", rd.DECODE_BWD_MODES)
def test_ray_decode_train_function_runs_each_mode(dtype, decode_bwd,
                                                  monkeypatch):
    """The card's autograd Function (``RayDecodeTrain``) on the CPU, with
    each kernel wrapper replaced by a stand-in that counts its calls and
    computes the plain version: each mode calls its forward and its
    backward once (the 'xla' backward is plain autograd, no K3) and gives
    ``ray_decode_bwd_plain``'s gradients from that forward's saves."""
    tdt = DTYPES[dtype][0]
    case = _decode_case(30)
    _, w32 = _port_w32(case, tdt)
    calls = {}

    def stand_in(name, fn):
        def call(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **kw)
        call.launches = 0
        return call

    def bwd(vt, cells, pos, rf, w, saved, g_off, g_logit, **kw):
        return rd.ray_decode_bwd_plain(vt, cells, pos, rf, w, g_off, g_logit,
                                       dtype=w["pair_w1"].dtype, saved=saved,
                                       **kw)

    fwd = {"kernel_save": ("ray_decode_save", True),
           "kernel_save_all": ("ray_decode_save_all", "all")}
    for name, fn in (("ray_decode", lambda *a, **kw: rd.ray_decode_plain(
                         *a, **kw)),
                     ("ray_decode_save", lambda *a, **kw: rd.ray_decode_plain(
                         *a, **kw, saves=True)),
                     ("ray_decode_save_all",
                      lambda *a, **kw: rd.ray_decode_plain(*a, **kw,
                                                           saves="all")),
                     ("ray_decode_bwd", bwd)):
        monkeypatch.setattr(rd, name, stand_in(name, fn))
    table = T(case["table"]).to(tdt).requires_grad_()
    rf = T(case["ray_feat"]).to(tdt).requires_grad_()
    ops = [w32[k].detach().clone().requires_grad_()
           for k in rd.FORMAT.operands]
    args = (T(case["cells"]), T(case["pos"]))
    off, logit = rd.RayDecodeTrain.apply(
        (tdt, w32["dims"], 2, 0.001, False, decode_bwd), table, *args, rf,
        *ops)
    cot = (T(case["g_off"]), T(case["g_logit"]))
    torch.autograd.backward((off, logit), cot)
    name, saves = fwd.get(decode_bwd, ("ray_decode", False))
    want_calls = {name: 1}
    if decode_bwd != "xla":
        want_calls["ray_decode_bwd"] = 1
    assert calls == want_calls
    w = common.cast_operands(w32, rd.FORMAT, tdt)
    plain = (T(case["table"]).to(tdt), *args, T(case["ray_feat"]).to(tdt))
    saved = rd.ray_decode_plain(*plain, w, saves=saves)[2] if saves else None
    ref = rd.ray_decode_bwd_plain(*plain, w, *cot, dtype=tdt, saved=saved)
    np.testing.assert_array_equal(N(off), N(rd.ray_decode_plain(*plain, w)[0]))
    np.testing.assert_array_equal(N(table.grad), N(ref[0].to(tdt)))
    np.testing.assert_array_equal(N(rf.grad), N(ref[1].to(tdt)))
    for k, g in zip(rd.FORMAT.operands, ops):
        np.testing.assert_array_equal(N(g.grad), N(ref[2][k]), err_msg=k)


# -- losses ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def loss_case():
    """Training inputs of both frameworks and random stage-1 outputs."""
    cfg = load_config(overrides=tiny_overrides("float32"))
    jstatic = jax_build_static(jax_load_config(overrides=tiny_overrides(
        "float32")))
    raw = synthetic_batch(5, 2, H, W)
    jin = _jax_train_inputs(jstatic, raw, key=1)
    inp = lidf.prepare_inputs(
        build_static(cfg), {k: T(v) for k, v in raw.items()}, train=True,
        valid_idx=T(jin["valid_idx"]), miss_start=T(jin["miss_start"]))
    rng = np.random.default_rng(28)
    b, r, _ = inp["pair_valid"].shape
    gt = np.asarray(jin["gt_pos"])
    out = {"pred_pos": (gt + 0.05 * rng.normal(size=gt.shape)).astype(
               np.float32),
           "prob_logit": rng.normal(size=(b, r, KB)).astype(np.float32),
           "pair_valid": np.asarray(jin["pair_valid"])[..., :KB]}
    sm = np.asarray(jmasked.masked_softmax(out["prob_logit"],
                                           out["pair_valid"]))
    out["prob_softmax"] = sm
    return jin, inp, out


def test_masked_mean_and_hard_neg_mean_match():
    rng = np.random.default_rng(29)
    x = rng.normal(size=(4, 50)).astype(np.float32)
    m = rng.random((4, 50)) < 0.6
    np.testing.assert_allclose(N(lidf.masked_mean(T(x), T(m))),
                               np.asarray(jlidf.masked_mean(x, m)), rtol=1e-6)
    for ratio in (0.1, 0.5):
        np.testing.assert_allclose(
            N(lidf.hard_neg_mean(T(x), T(m), ratio)),
            np.asarray(jlidf.hard_neg_mean(x, m, ratio)), rtol=1e-6)


def test_masked_log_softmax_matches():
    rng = np.random.default_rng(30)
    z = rng.normal(size=(40, 8)).astype(np.float32)
    m = rng.random((40, 8)) < 0.6
    m[0] = False
    got = N(masked.masked_log_softmax(T(z), T(m)))
    np.testing.assert_allclose(got, np.asarray(jmasked.masked_log_softmax(z, m)),
                               rtol=1e-6, atol=1e-6)


def test_normals_match():
    rng = np.random.default_rng(31)
    pcl = rng.normal(size=(2, 12, 16, 3)).astype(np.float32)
    pcl[:, 3:5, 4:6] = 0  # flat patches: zero cross products
    for got, want in zip(normals.surface_normals(T(pcl)),
                         jnormals.surface_normals(pcl)):
        np.testing.assert_allclose(N(got), np.asarray(want), atol=1e-6)
    pl = pcl.transpose(0, 3, 1, 2)
    for got, want in zip(normals.surface_normals_planar(T(pl)),
                         jnormals.surface_normals_planar(pl)):
        np.testing.assert_allclose(N(got), np.asarray(want), atol=1e-6)


def test_window_in_mask_and_compose_pred_image_match(loss_case):
    jin, inp, out = loss_case
    r = inp["miss_slot"].shape[1]
    np.testing.assert_array_equal(
        lidf.window_in_mask(inp["miss_mask_flat"], inp["miss_rank"],
                            inp["miss_start"], r).numpy(),
        np.asarray(jlidf.window_in_mask(jin["miss_mask_flat"],
                                        jin["miss_rank"], jin["miss_start"],
                                        r)))
    cot = np.random.default_rng(32).normal(
        size=np.asarray(jin["xyz_flat"]).shape).astype(np.float32)

    def jf(v):
        return jnp.sum(jlidf.compose_pred_image(jin["xyz_flat"], v, jin,
                                                True) * cot)

    jv, jg = jax.value_and_grad(jf)(jnp.asarray(out["pred_pos"]))
    v = T(out["pred_pos"]).requires_grad_()
    y = (lidf.compose_pred_image(inp["xyz_flat"], v, inp, True) * T(cot)).sum()
    y.backward()
    np.testing.assert_allclose(N(y), np.asarray(jv), rtol=1e-5)
    np.testing.assert_array_equal(N(v.grad), np.asarray(jg))


@pytest.mark.parametrize("hard_neg", [False, True])
def test_lidf_loss_matches_with_gradients(loss_case, hard_neg):
    jin, inp, out = loss_case
    kw = dict(train=True, img_hw=(H, W), smooth_w=0.5, hard_neg=hard_neg,
              hard_neg_ratio=0.2)

    def jf(pp, pl):
        losses = jlidf.lidf_loss(jin, {**out, "pred_pos": pp,
                                       "prob_logit": pl}, **kw)
        return losses["loss_net"], losses

    (_, jl), jg = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(
        jnp.asarray(out["pred_pos"]), jnp.asarray(out["prob_logit"]))
    pp = T(out["pred_pos"]).requires_grad_()
    pl = T(out["prob_logit"]).requires_grad_()
    losses = lidf.lidf_loss(inp, {"pred_pos": pp, "prob_logit": pl,
                                  "pair_valid": T(out["pair_valid"]),
                                  "prob_softmax": T(out["prob_softmax"])},
                            **kw)
    losses["loss_net"].backward()
    assert set(losses) == set(jl)
    for k in jl:
        # a few f32 reductions over the image, in another order
        np.testing.assert_allclose(N(losses[k]), np.asarray(jl[k]), rtol=1e-5,
                                   err_msg=k)
    assert_rel_max(N(pp.grad), jg[0], 1e-5, "d pred_pos")
    assert_rel_max(N(pl.grad), jg[1], 1e-5, "d prob_logit")


# -- optimizers ----------------------------------------------------------------

@pytest.mark.parametrize("name", ["adam", "adamw", "rmsprop", "sgd"])
def test_optimizer_with_step_lr_matches_optax(name):
    rng = np.random.default_rng(33)
    p0 = {"a": rng.normal(size=(5, 3)).astype(np.float32),
          "b": rng.normal(size=(7,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in p0.items()} for _ in range(4)]
    # the rate drops 10x after two updates: steps 0-1 at 1e-2, 2-3 at 1e-3
    jsched = jstate.step_lr(1e-2, 1, 2, 0.1)
    tx = jstate.make_optimizer(name, jsched, weight_decay=0.01)
    jp, st = {k: jnp.asarray(v) for k, v in p0.items()}, None
    st = tx.init(jp)
    params = {k: torch.nn.Parameter(T(v)) for k, v in p0.items()}
    sched = step_lr(1e-2, 1, 2, 0.1)
    opt = make_optimizer(name, params.values(), sched, weight_decay=0.01)
    state = TrainState(model=None, optimizer=opt, lr=sched)
    for g in grads:
        upd, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in params.items():
            p.grad = T(g[k])
        state.apply_gradients()
        for k, p in params.items():
            # 1e-6: 1e-4 of a step of 1e-2 (the bias corrections are
            # rounded in f64 by torch, in f32 by optax); a step at the wrong
            # rate would be off by 1e-3
            np.testing.assert_allclose(N(p), np.asarray(jp[k]), rtol=0,
                                       atol=1e-6, err_msg=f"{name} {k}")
    assert state.step == 4


# -- the whole train step and the eval step -------------------------------------

def _both_models(dtype, seed=34):
    jcfg = jax_load_config(overrides=tiny_overrides(dtype))
    jstatic = jax_build_static(jcfg)
    jmodel = jax_build_lidf(jcfg, jstatic)
    raw = synthetic_batch(seed, 2, H, W)
    jin = _jax_train_inputs(jstatic, raw, key=seed)
    var = jax.jit(lambda k, i: jmodel.init(k, i, train=False,
                                           use_gt_label=False))(
        jax.random.key(1), jin)
    var = randomize(jax.device_get(var), np.random.default_rng(seed))
    # decoder outputs inside (0, 1), as builder.randomize_weights_ sets
    # them: at the soft clamp's kinks (0 and 1) the derivative jumps 100x,
    # and a 1e-7 difference of a pre-squash output would flip it
    for dec, bias in (("offset_dec", 0.5 / jcfg.model.n_iter),
                      ("prob_dec", 0.5)):
        last = var["params"][dec]["_MLP4_0"]["Dense_3"]
        last["kernel"] = last["kernel"] * 0.25
        last["bias"] = np.full_like(last["bias"], bias)
    cfg = load_config(overrides=tiny_overrides(dtype))
    model = lidf_from_jax(var, build_lidf(cfg, build_static(cfg)))
    return jcfg, jstatic, jmodel, var, raw, cfg, model


def _jax_step(jcfg, jstatic, jmodel, var, raw, epoch, compiler_options=None):
    """JAX's inputs, gradients, losses and new batch_stats of one step."""
    batch = {k: jnp.asarray(v) for k, v in raw.items()}

    def jstep(params, stats, b, key, ep):
        inputs = jlidf.prepare_inputs(jstatic, b, key, train=True)

        def loss_fn(p):
            o, mut = jmodel.apply({"params": p, "batch_stats": stats}, inputs,
                                  train=True,
                                  use_gt_label=ep < jcfg.model.maxpool_label_epo,
                                  mutable=["batch_stats"])
            kw = jsteps._loss_kwargs(jcfg, True, ep)
            kw["prob_w"] = jcfg.loss.prob_w
            losses = jlidf.lidf_loss(inputs, o, **kw)
            return losses["loss_net"], (losses, mut["batch_stats"])

        grads, aux = jax.grad(loss_fn, has_aux=True)(params)
        return inputs, grads, aux

    args = (var["params"], var["batch_stats"], batch, jax.random.key(2),
            jnp.asarray(epoch))
    jin, grads, (losses, stats) = jax.jit(jstep).lower(*args).compile(
        compiler_options=compiler_options)(*args)
    return jin, jax.device_get(grads), losses, jax.device_get(stats)


# bf16: the port's gradient of each parameter against JAX's bf16 gradient,
# by the relative norm of the difference; the largest and the median of each
# group of parameters may reach (measured at this seed, epochs 0 / 10:
# ResNet largest 0.132 / 0.151, median 0.106 / 0.114; PointNet 0.074 / 0.041,
# 0.027 / 0.032; offset decoder 0.053 / 0.078, 0.019 / 0.029; probability
# decoder 0.022, 0.016 at both). 11 of the 68 parameters keep within 2e-2,
# all but one in the decoders. A ResNet whose batch norm ran in bf16, or
# whose first convolution kept f32, gave ResNet medians of 0.24-0.27 and
# PointNet medians of 0.068-0.080.
BF16_GRAD_LIMITS = {"resnet": (0.25, 0.17), "pnet": (0.12, 0.05),
                    "offset_dec": (0.12, 0.05), "prob_dec": (0.04, 0.03)}


@pytest.mark.parametrize("dtype,epoch", [("float32", 0), ("float32", 10),
                                         ("bfloat16", 0), ("bfloat16", 10)])
def test_train_step_matches_jax_grad(dtype, epoch):
    """epoch 0: the curriculum's labelled slot; epoch 10: the predicted.

    f32: every gradient within 1e-4 of its largest value (plus 1e-7 for
    sums that cancel to ~0, as the probability decoder's last bias does).

    bf16: JAX is compiled with ``xla_allow_excess_precision`` off, so that
    XLA rounds to bf16 wherever the program does, as the port does (left
    on, XLA keeps f32 across some of those roundings, and the port's
    gradients lie about twice as far from JAX's). Even so, the two
    frameworks' convolutions and products sum in other orders, a bf16
    rounding flips here and there, and the backward through the train-mode
    batch norms amplifies those flips: a bound of 2e-2 per parameter holds
    for 11 of 68 parameters, and the ResNet's gradients miss it by 2-8x
    (BF16_GRAD_LIMITS gives each group's readings and limits). A rounding
    missed or added in the ResNet shows in the group's median."""
    jcfg, jstatic, jmodel, var, raw, cfg, model = _both_models(dtype)
    f32 = dtype == "float32"
    jin, jgrads, jlosses, jstats = _jax_step(
        jcfg, jstatic, jmodel, var, raw, epoch,
        None if f32 else {"xla_allow_excess_precision": False})
    state = TrainState.create(model, cfg.training, steps_per_epoch=10)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    losses = make_lidf_train_step(cfg, model, "cpu")(
        state, {k: T(v) for k, v in raw.items()}, None, epoch,
        valid_idx=T(jin["valid_idx"]), miss_start=T(jin["miss_start"]))
    for k in jlosses:
        if f32:  # one algebra summed in another order
            np.testing.assert_allclose(N(losses[k]), np.asarray(jlosses[k]),
                                       rtol=1e-4, atol=1e-6, err_msg=k)
        else:    # bf16 rounds at other places: a few ulps of each term
            np.testing.assert_allclose(N(losses[k]), np.asarray(jlosses[k]),
                                       rtol=2e-2, atol=1e-3, err_msg=k)
    want = lidf_grads_from_jax(jgrads, model)
    errs = {}
    for name, p in model.named_parameters():
        if f32:
            assert_rel_max(N(p.grad), N(want[name]), 1e-4, name, atol=1e-7)
        else:
            diff = np.linalg.norm(N(p.grad) - N(want[name]))
            # a sum that cancels to ~1e-9 (the probability decoder's last
            # bias) is held to 1e-7, as in f32
            errs[name] = (0.0 if diff <= 1e-7
                          else diff / np.linalg.norm(N(want[name])))
        assert (p.detach() != before[name]).any(), f"{name} did not move"
    if not f32:
        assert {n.split(".")[0] for n in errs} == set(BF16_GRAD_LIMITS)
        for group, (largest, median) in BF16_GRAD_LIMITS.items():
            e = {n: v for n, v in errs.items() if n.split(".")[0] == group}
            worst, med = max(e, key=e.get), np.median(list(e.values()))
            assert e[worst] <= largest and med <= median, \
                f"{group}: largest {e[worst]:.3g} ({worst}), median {med:.3g}"
    got_stats = resnet_batch_stats(model.resnet)
    for path, node in _leaves(jstats["resnet"]):
        g = got_stats
        for key in path:
            g = g[key]
        # the batch moments of the same activations (bf16: of activations a
        # few bf16 ulps apart)
        check = assert_rel_max if f32 else assert_rel_norm
        check(g, node, 1e-4 if f32 else 2e-2, "/".join(path))


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)


def test_eval_step_matches_jax():
    jcfg, jstatic, jmodel, var, raw, cfg, model = _both_models("float32", 35)
    tx = jstate.make_optimizer("adam", 1e-3)
    jstate_ = jstate.TrainState.create(var["params"], var["batch_stats"], tx)
    batch = {k: jnp.asarray(v) for k, v in raw.items()}
    jin, jout, jl = jsteps.make_lidf_eval_step(jcfg, jmodel)(
        jstate_, batch, jax.random.key(3))
    state = TrainState.create(model, cfg.training, steps_per_epoch=10)
    inp, out, losses = make_lidf_eval_step(cfg, model, "cpu")(
        state, {k: T(v) for k, v in raw.items()},
        valid_idx=T(jin["valid_idx"]))
    assert not model.training
    for k in jl:
        np.testing.assert_allclose(N(losses[k]), np.asarray(jl[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(out["max_slot"].numpy(),
                                  np.asarray(jout["max_slot"]))
    # 1e-4: f32 algebra through the whole model, in another order
    np.testing.assert_allclose(N(out["pred_pos"]), np.asarray(jout["pred_pos"]),
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("factory", [make_lidf_train_step, make_lidf_eval_step])
def test_steps_default_to_the_card_and_raise_without_one(factory, monkeypatch):
    """Like serving, the steps run on cuda unless the CPU is asked for, and
    never fall back to it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = load_config(overrides=tiny_overrides("float32"))
    model = build_lidf(cfg, build_static(cfg))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        factory(cfg, model)
    assert next(model.parameters()).device.type == "cpu"
