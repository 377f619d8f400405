"""The port's stage-2 (RefineNet) training slice against the JAX package, on
the CPU.

The perturbation, the stage-2 loss, the differentiable IEF decode (K4's
training entry, through the plain version a CPU tensor takes) against
``jax.vjp`` of ``xla_ief_rows``, and the whole refine train step against
``jax.grad`` of the loss of ``_refine_train_core`` (frozen stage 1, the
perturbation, ``forward_times`` iterations), the eval step (``use_all_pix``
both ways) and the vis steps. Every case feeds both frameworks the same
seeded numpy inputs and weights; the random draws (valid points, window
starts, the perturbation's three uniforms) are JAX's, passed in. The JAX
side decodes through its plain XLA paths (``tpu.use_pallas_decode`` off).

Tolerances: f32 compares one algebra summed in another order (1e-5 of the
largest value for the losses and the decode, 1e-4 for the whole step's
gradients, as each case states); bf16 compares two frameworks that round
at other places, by the relative norm of the difference, per group of
parameters for the whole step (``BF16_GRAD_LIMITS``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from implicit_depth_tpu.builder import build_lidf as jax_build_lidf
from implicit_depth_tpu.builder import build_refine as jax_build_refine
from implicit_depth_tpu.builder import build_static as jax_build_static
from implicit_depth_tpu.config import load_config as jax_load_config
from implicit_depth_tpu.models import lidf as jlidf
from implicit_depth_tpu.models import refine as jrefine
from implicit_depth_tpu.ops.pallas_ray_decode import xla_ief_rows
from implicit_depth_tpu.train import state as jstate
from implicit_depth_tpu.train import steps as jsteps
from implicit_depth_torch.builder import build_lidf, build_refine, build_static
from implicit_depth_torch.config import load_config
from implicit_depth_torch.data.synthetic import synthetic_batch
from implicit_depth_torch.models import lidf
from implicit_depth_torch.models.refine import perturb_pred_pos, refine_loss
from implicit_depth_torch.ops import ray_decode as rd
from implicit_depth_torch.train.state import TrainState
from implicit_depth_torch.train.steps import (
    make_lidf_vis_step,
    make_refine_eval_step,
    make_refine_train_step,
    make_refine_vis_step,
)
from implicit_depth_torch.weights import (
    lidf_from_jax,
    refine_from_jax,
    refine_grads_from_jax,
)

torch.set_num_threads(2)
# a first torch.sin before any JAX computation (see test_torch_port_ops.py)
torch.sin(torch.zeros(1 << 16))
H, W = 48, 64
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def T(a):
    return torch.from_numpy(np.array(a))


def N(t):
    return t.detach().float().numpy()


def assert_rel_max(got, ref, rtol, what="", atol=0.0):
    """max |got - ref| <= rtol · max |ref| + atol."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = np.abs(ref).max()
    err = np.abs(got - ref).max()
    assert err <= rtol * scale + atol, \
        f"{what}: max error {err:.3g} of scale {scale:.3g}"


def rel_norm(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)


def tiny_overrides(dtype):
    # per_ray stage 1 with K=12 > kb=8; the refine network narrow; the
    # surface-normal term gated on from epoch 5, the labelled-slot
    # curriculum until epoch 6 (the default): the cases run at epochs 0
    # and 10, on both sides of both
    return {
        "mask_type": "all",
        "dataset": {"img_height": H, "img_width": W},
        "model": {"rgb_out": 8, "pnet_out": 16, "pnet_gf": 8, "imnet_gf": 8,
                  "resnet_stages": [1, 1, 1, 1]},
        "refine": {"pnet_out": 16, "pnet_gf": 8, "imnet_gf": 8},
        "grid": {"res": 8, "miss_sample_num": 256, "valid_sample_num": 512},
        "loss": {"surf_norm_epo": 5},
        "tpu": {"max_pairs_per_ray": 12, "pairs_budget_per_ray": 8,
                "use_pallas_decode": False, "compute_dtype": dtype},
    }


def randomize(tree, rng):
    """Every leaf redrawn at O(1) activation scale (as the randomize of
    test_torch_port_slice.py)."""
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


def _inside_the_clamp(params, n_iter):
    """Each decoder's raw output near 0.5 (as builder.randomize_weights_
    sets it): at the soft clamp's kinks the derivative jumps 100x, and a
    1e-7 difference of a pre-squash output would flip it."""
    for dec, bias in (("offset_dec", 0.5 / n_iter), ("prob_dec", 0.5)):
        if dec in params:
            last = params[dec]["_MLP4_0"]["Dense_3"]
            last["kernel"] = last["kernel"] * 0.25
            last["bias"] = np.full_like(last["bias"], bias)


def _jax_noise(key, b):
    """The three uniforms of JAX's perturb_pred_pos from its key."""
    k1, k2, k3 = jax.random.split(key, 3)
    return {n: np.asarray(jax.random.uniform(k, (b,)))
            for n, k in zip(("apply", "bucket", "u"), (k1, k2, k3))}


# -- the models of both frameworks ---------------------------------------------

class Case:
    """JAX and port stage-1 and stage-2 models with the same randomized
    weights, and a training batch of 2 images."""

    def __init__(self, dtype, seed=40, batch=2):
        self.jcfg = jax_load_config(overrides=tiny_overrides(dtype))
        self.jstatic = jax_build_static(self.jcfg)
        self.jlidf = jax_build_lidf(self.jcfg, self.jstatic)
        self.jref = jax_build_refine(self.jcfg, self.jstatic)
        self.raw = synthetic_batch(seed, batch, H, W)
        self.batch = {k: jnp.asarray(v) for k, v in self.raw.items()}
        jin = jax.jit(lambda b, k: jlidf.prepare_inputs(
            self.jstatic, b, k, train=True))(self.batch, jax.random.key(0))
        rng = np.random.default_rng(seed)
        lv = jax.jit(lambda k, i: self.jlidf.init(k, i, train=False,
                                                  use_gt_label=False))(
            jax.random.key(1), jin)
        self.lvars = randomize(jax.device_get(lv), rng)
        _inside_the_clamp(self.lvars["params"], self.jcfg.model.n_iter)
        lout = jax.jit(lambda v, i: self.jlidf.apply(
            v, i, train=False, use_gt_label=False))(self.lvars, jin)
        rv = jax.jit(lambda k, i, o: self.jref.init(k, i, o, o["pred_pos"]))(
            jax.random.key(2), jin, lout)
        self.rparams = randomize(jax.device_get(rv["params"]), rng)
        _inside_the_clamp(self.rparams, self.jcfg.refine.n_iter)
        self.cfg = load_config(overrides=tiny_overrides(dtype))

    def port_models(self, static=None):
        static = static or build_static(self.cfg)
        return (lidf_from_jax(self.lvars, build_lidf(self.cfg, static)),
                refine_from_jax(self.rparams, build_refine(self.cfg, static)))

    def tbatch(self):
        return {k: T(v) for k, v in self.raw.items()}


@pytest.fixture(scope="module")
def case_f32():
    return Case("float32")


@pytest.fixture(scope="module")
def case_bf16():
    return Case("bfloat16")


# -- perturbation ------------------------------------------------------------

def test_perturb_pred_pos_matches_jax_with_its_draw():
    rng = np.random.default_rng(41)
    b = 64
    pred = rng.normal(size=(b, 30, 3)).astype(np.float32)
    dirs = rng.normal(size=(b, 30, 3)).astype(np.float32)
    key = jax.random.key(5)
    want = np.asarray(jrefine.perturb_pred_pos(key, pred, dirs, 0.8))
    noise = _jax_noise(key, b)
    # every bucket of the mixture and both sides of perturb_prob occur
    assert ((noise["apply"] < 0.8).any() and (noise["apply"] >= 0.8).any())
    assert len(np.unique(np.digitize(noise["bucket"], [0.5, 0.8, 0.9]))) == 4
    got = perturb_pred_pos(T(pred), T(dirs), 0.8,
                           **{k: T(v) for k, v in noise.items()})
    np.testing.assert_array_equal(N(got), want)


def test_perturb_pred_pos_draws_from_its_generator():
    pred, dirs = torch.zeros((3, 5, 3)), torch.ones((3, 5, 3))

    def draw(seed):
        return perturb_pred_pos(pred, dirs, 1.0,
                                generator=torch.Generator().manual_seed(seed))

    a = draw(7)
    np.testing.assert_array_equal(N(a), N(draw(7)))
    assert not torch.equal(a, draw(8))
    shift = a[:, 0, 0]
    assert (shift.abs() <= 0.1).all() and (shift != 0).all()
    assert (a == shift[:, None, None]).all()  # one scalar per image
    np.testing.assert_array_equal(N(perturb_pred_pos(pred, dirs, 0.0,
                                                     generator=None)), N(pred))


# -- the stage-2 loss -----------------------------------------------------------

@pytest.mark.parametrize("hard_neg", [False, True])
def test_refine_loss_matches_with_gradients(case_f32, hard_neg):
    c = case_f32
    jin = jax.jit(lambda b, k: jlidf.prepare_inputs(
        c.jstatic, b, k, train=True))(c.batch, jax.random.key(3))
    inp = lidf.prepare_inputs(build_static(c.cfg), c.tbatch(), train=True,
                              valid_idx=T(jin["valid_idx"]),
                              miss_start=T(jin["miss_start"]))
    gt = np.asarray(jin["gt_pos"])
    pred = (gt + 0.05 * np.random.default_rng(42).normal(size=gt.shape)
            ).astype(np.float32)
    kw = dict(train=True, img_hw=(H, W), smooth_w=0.5, hard_neg=hard_neg,
              hard_neg_ratio=0.2)

    def jf(pp):
        losses = jrefine.refine_loss(jin, pp, **kw)
        return losses["loss_net"], losses

    (_, jl), jg = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(pred))
    pp = T(pred).requires_grad_()
    losses = refine_loss(inp, pp, **kw)
    losses["loss_net"].backward()
    assert set(losses) == set(jl)
    for k in jl:
        # a few f32 reductions over the image, in another order
        np.testing.assert_allclose(N(losses[k]), np.asarray(jl[k]), rtol=1e-5,
                                   err_msg=k)
    assert losses["smooth_loss"].item() > 0
    assert_rel_max(N(pp.grad), jg, 1e-5, "d pred_pos")


# -- the differentiable IEF decode (K4's training entry) -----------------------

def _ief_case(seed, use_sigmoid):
    rng = np.random.default_rng(seed)
    n, c_end, c_roi, c_dir, c_pos, g = 150, 16, 32, 27, 51, 8
    c_rc = c_roi + c_dir
    w = {"enc_w": rng.normal(size=(1, 16)).astype(np.float32),
         "enc_b": (0.1 * rng.normal(size=(16,))).astype(np.float32)}
    dims = [c_end + c_rc + c_pos + 16, 4 * g, 2 * g, g, 1]
    for i in range(4):
        w[f"w{i + 1}"] = (rng.normal(size=dims[i:i + 2])
                          / np.sqrt(dims[i])).astype(np.float32)
        w[f"b{i + 1}"] = (0.1 * rng.normal(size=(dims[i + 1],))).astype(
            np.float32)
    # the raw offset near 0.5 after both iterations: inside the clamp
    w["w4"] *= 0.25
    w["b4"][:] = 0.25
    rows = [rng.normal(size=(n, c)).astype(np.float32)
            for c in (c_end, c_rc, c_pos)]
    g_out = rng.normal(size=(n,)).astype(np.float32)
    return rows, w, g_out, (c_end, c_rc, c_pos, c_dir), use_sigmoid


def _port_ief_grads(rows, w, g_out, dims, use_sigmoid, dtype, rc_grad,
                    function=False):
    """(output, d end, d rc or None, d pos, {weight: gradient}) of the
    port's training decode: ief_decode_train, or with ``function`` the
    card's autograd Function (K4 forward, the recompute backward), whose
    forward takes the plain version on a CPU tensor."""
    c_end, c_rc, c_pos, c_dir = dims
    params = {k: T(v).requires_grad_() for k, v in w.items()}
    w32 = rd.split_ief_weights(params, c_end, c_rc, c_pos, c_dir, dtype)
    leaves = [T(r).to(dtype).requires_grad_(need)
              for r, need in zip(rows, (True, rc_grad, True))]
    kw = dict(n_iter=2, init_offset=0.001, use_sigmoid=use_sigmoid)
    if function:
        out = rd.IefDecodeTrain.apply((dtype, w32["dims"], 2, 0.001,
                                       use_sigmoid), *leaves,
                                      *(w32[k] for k in rd._K4_WEIGHTS))
    else:
        out = rd.ief_decode_train(*leaves, w32, dtype, **kw)
    (out * T(g_out)).sum().backward()
    return (out, *(t.grad for t in leaves),
            {k: p.grad for k, p in params.items()})


@pytest.mark.parametrize("use_sigmoid", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ief_decode_train_grads_match_jax(dtype, use_sigmoid):
    """f32: 1e-5 of each tensor's largest value (one algebra in another
    summation order). bf16: the relative norm of the difference within
    2e-2: JAX rounds each weight's cotangent to bf16 at its cast, the port
    carries the weight gradients in f32 (as the JAX kernel's backward
    does); the outputs, made the same way by both, within 4e-3."""
    rows, w, g_out, dims, use_sigmoid = _ief_case(43, use_sigmoid)
    tdt, jdt = DTYPES[dtype]
    c_end, c_rc, c_pos, c_dir = dims

    def ref(e, rc, p, ws):
        return xla_ief_rows(e.astype(jdt), rc.astype(jdt), p.astype(jdt), ws,
                            c_dir=c_dir, use_sigmoid=use_sigmoid, dtype=jdt)

    jout, vjp = jax.vjp(ref, *rows, w)
    jd_end, jd_rc, jd_pos, jd_w = vjp(jnp.asarray(g_out))
    out, d_end, d_rc, d_pos, d_w = _port_ief_grads(
        rows, w, g_out, dims, use_sigmoid, tdt, rc_grad=True)
    pairs = [("out", out, jout), ("d end", d_end, jd_end),
             ("d rc", d_rc, jd_rc), ("d pos", d_pos, jd_pos)]
    pairs += [(k, d_w[k], jd_w[k]) for k in w]
    for what, got, want in pairs:
        if dtype == "float32":
            assert_rel_max(N(got), np.asarray(want, np.float32), 1e-5, what)
        elif what == "out":
            np.testing.assert_allclose(N(got), np.asarray(want), atol=4e-3,
                                       rtol=0)
        else:
            e = rel_norm(N(got), np.asarray(want, np.float32))
            assert e <= 2e-2, f"{what}: relative norm error {e:.3g}"


@pytest.mark.parametrize("rc_grad", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ief_decode_train_function_is_the_plain_gradient(dtype, rc_grad):
    """The card's autograd Function (run here with the plain forward a CPU
    tensor takes): its backward is autograd of the plain decode on the
    same inputs, bit for bit; d rc only when rc asks for one."""
    rows, w, g_out, dims, _ = _ief_case(44, False)
    tdt = DTYPES[dtype][0]
    plain = _port_ief_grads(rows, w, g_out, dims, False, tdt, rc_grad)
    fn = _port_ief_grads(rows, w, g_out, dims, False, tdt, rc_grad,
                         function=True)
    assert (fn[2] is not None) == rc_grad
    for got, want in zip(fn[:4], plain[:4]):
        if want is not None:
            np.testing.assert_array_equal(N(got), N(want))
    for k in w:
        np.testing.assert_array_equal(N(fn[4][k]), N(plain[4][k]), err_msg=k)


def test_ief_decode_refuses_a_gradient_it_cannot_carry():
    """The forward-only entry raises on an operand that asks for a
    gradient, instead of dropping it; it decodes under no_grad."""
    rows, w, _, (c_end, c_rc, c_pos, c_dir), _ = _ief_case(45, False)
    params = {k: T(v).requires_grad_() for k, v in w.items()}
    live = rd.prep_ief_weights(params, c_end, c_rc, c_pos, c_dir,
                               torch.float32)
    frozen = rd.prep_ief_weights({k: T(v) for k, v in w.items()}, c_end,
                                 c_rc, c_pos, c_dir, torch.float32)
    end = T(rows[0]).requires_grad_()
    with pytest.raises(RuntimeError, match="carries no gradient"):
        rd.ief_decode(end, T(rows[1]), T(rows[2]), frozen)
    with pytest.raises(RuntimeError, match="carries no gradient"):
        rd.ief_decode(T(rows[0]), T(rows[1]), T(rows[2]), live)
    with torch.no_grad():
        got = rd.ief_decode(end, T(rows[1]), T(rows[2]), live)
    np.testing.assert_array_equal(
        N(got), N(rd.ief_decode(T(rows[0]), T(rows[1]), T(rows[2]), frozen)))


def test_prep_ief_weights_is_the_cast_split():
    """The serving operands are the training split cast as K4 takes it."""
    _, w, _, (c_end, c_rc, c_pos, c_dir), _ = _ief_case(46, False)
    tw = {k: T(v) for k, v in w.items()}
    for dt in (torch.float32, torch.bfloat16):
        prep = rd.prep_ief_weights(tw, c_end, c_rc, c_pos, c_dir, dt)
        split = rd.split_ief_weights(tw, c_end, c_rc, c_pos, c_dir, dt)
        assert all(split[k].dtype == torch.float32 for k in rd._K4_WEIGHTS)
        cast = rd.cast_ief_operands(split, dt)
        for k in rd._K4_WEIGHTS:
            assert prep[k].dtype == cast[k].dtype, k
            np.testing.assert_array_equal(N(prep[k]), N(cast[k]), err_msg=k)


# -- the whole refine train step -------------------------------------------------

def _jax_refine_step(c, epoch, key=7, compiler_options=None):
    """JAX's inputs, refine gradients, losses and perturbation draws of one
    step: the body of ``_refine_train_core`` with ``jax.grad`` of its
    ``loss_fn`` kept, instead of the update."""
    jcfg = c.jcfg
    forward_times = int(jcfg.refine.forward_times)
    perturb_prob = float(jcfg.refine.perturb_prob)
    assert jcfg.refine.perturb

    def jstep(params, lv, b, k, ep):
        k_prep, k_noise = jax.random.split(k)
        inputs = jlidf.prepare_inputs(c.jstatic, b, k_prep, train=True,
                                      mask_type=jcfg.mask_type)
        lout = c.jlidf.apply(lv, inputs, train=False,
                             use_gt_label=ep < jcfg.model.maxpool_label_epo)
        lout = jax.lax.stop_gradient(lout)
        inputs = jax.lax.stop_gradient(inputs)

        def loss_fn(p):
            pred = lout["pred_pos"]
            for it in range(forward_times):
                if it == 0:
                    pred = jrefine.perturb_pred_pos(k_noise, pred,
                                                    inputs["miss_dir"],
                                                    perturb_prob)
                pred = c.jref.apply({"params": p}, inputs, lout, pred)
            losses = jrefine.refine_loss(
                inputs, pred, **jsteps._loss_kwargs(jcfg, True, ep))
            return losses["loss_net"], losses

        grads, losses = jax.grad(loss_fn, has_aux=True)(params)
        return inputs, grads, losses, k_noise

    args = (c.rparams, c.lvars, c.batch, jax.random.key(key),
            jnp.asarray(epoch))
    jin, grads, losses, k_noise = jax.jit(jstep).lower(*args).compile(
        compiler_options=compiler_options)(*args)
    noise = _jax_noise(k_noise, c.raw["rgb"].shape[0])
    return jin, jax.device_get(grads), losses, noise


# bf16: the port's gradient of each refine parameter against JAX's bf16
# gradient, by the relative norm of the difference; the largest and the
# median of each group may reach these limits (readings at this seed,
# epochs 0 / 10: PointNet largest 0.027 / 0.036, median 0.012 / 0.016;
# offset decoder 0.016 / 0.023, 0.011 / 0.015; f32 at most 2.0e-6). The
# two frameworks round the decode's layer 1 at other places (JAX's flax IEF
# rounds the embed product and each part to bf16, the port's K4 algebra
# adds the parts in f32), and JAX rounds each weight's cotangent to bf16 at
# its cast. Limits about twice the largest readings.
BF16_GRAD_LIMITS = {"pnet": (0.07, 0.035), "offset_dec": (0.05, 0.03)}


@pytest.mark.parametrize("dtype,epoch", [("float32", 0), ("float32", 10),
                                         ("bfloat16", 0), ("bfloat16", 10)])
def test_refine_train_step_matches_jax_grad(case_f32, case_bf16, dtype,
                                            epoch):
    """epoch 0: the curriculum's labelled slot and no surface-normal term;
    epoch 10: the predicted slot and the surface-normal term (the frozen
    stage 1 runs in eval mode in both packages, where the curriculum does
    not apply; the losses show the gate).

    f32: the losses within 1e-5, every refine gradient within 1e-4 of its
    largest value (plus 1e-7 for a sum that cancels to ~0). bf16: JAX is
    compiled with ``xla_allow_excess_precision`` off, as for stage 1; the
    losses within 2e-2 relative, the gradients per group
    (``BF16_GRAD_LIMITS``). Also: the stage-1 model's parameters and
    buffers are left bit for bit, every refine parameter moved, and every
    refine gradient is finite and not all zero."""
    c = case_f32 if dtype == "float32" else case_bf16
    f32 = dtype == "float32"
    jin, jgrads, jlosses, noise = _jax_refine_step(
        c, epoch, compiler_options=None if f32 else {
            "xla_allow_excess_precision": False})
    lidf_m, ref = c.port_models()
    state = TrainState.create(ref, c.cfg.training, steps_per_epoch=10)
    lidf_before = {k: v.clone() for k, v in lidf_m.state_dict().items()}
    before = {n: p.detach().clone() for n, p in ref.named_parameters()}
    losses = make_refine_train_step(c.cfg, lidf_m, ref, "cpu")(
        state, c.tbatch(), None, epoch, valid_idx=T(jin["valid_idx"]),
        miss_start=T(jin["miss_start"]),
        noise={k: T(v) for k, v in noise.items()})
    assert set(losses) == set(jlosses)
    assert (losses["surf_norm_loss"].item() > 0)
    for k in jlosses:
        if f32:  # one algebra summed in another order
            np.testing.assert_allclose(N(losses[k]), np.asarray(jlosses[k]),
                                       rtol=1e-5, atol=1e-7, err_msg=k)
        else:    # bf16 rounds at other places: a few ulps of each term
            np.testing.assert_allclose(N(losses[k]), np.asarray(jlosses[k]),
                                       rtol=2e-2, atol=1e-4, err_msg=k)
    want = refine_grads_from_jax(jgrads, ref)
    errs = {}
    for name, p in ref.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        assert (p.grad != 0).any(), f"{name}: zero gradient"
        if f32:
            assert_rel_max(N(p.grad), N(want[name]), 1e-4, name, atol=1e-7)
        else:
            errs[name] = rel_norm(N(p.grad), N(want[name]))
        assert (p.detach() != before[name]).any(), f"{name} did not move"
    for k, v in lidf_m.state_dict().items():
        assert torch.equal(v, lidf_before[k]), f"stage 1 changed: {k}"
    assert not any(p.requires_grad for p in lidf_m.parameters())
    assert len(state.optimizer.param_groups[0]["params"]) == len(before)
    if not f32:
        assert {n.split(".")[0] for n in errs} == set(BF16_GRAD_LIMITS)
        for group, (largest, median) in BF16_GRAD_LIMITS.items():
            e = {n: v for n, v in errs.items() if n.split(".")[0] == group}
            worst, med = max(e, key=e.get), np.median(list(e.values()))
            assert e[worst] <= largest and med <= median, \
                f"{group}: largest {e[worst]:.3g} ({worst}), median {med:.3g}"


def test_refine_step_losses_are_the_jax_steps(case_f32):
    """The JAX side of the step test is ``_refine_train_core``'s own loss:
    its jitted step (with the update) reports the same losses."""
    c = case_f32
    _, _, jlosses, _ = _jax_refine_step(c, 10)
    tx = jstate.make_optimizer("adam", 1e-3)
    jst = jstate.TrainState.create(c.rparams, {}, tx)
    _, core = jsteps.make_refine_train_step(c.jcfg, c.jlidf, c.jref)(
        jst, c.lvars, c.batch, jax.random.key(7), jnp.asarray(10))
    for k in jlosses:
        np.testing.assert_allclose(np.asarray(core[k]), np.asarray(jlosses[k]),
                                   rtol=1e-6, err_msg=k)


def test_refine_gradient_crosses_the_iterations(case_f32):
    """Iteration 1 reads iteration 0's output: cutting that link changes the
    decoder's gradients (the gradient flows through ``pred_pos`` from one
    iteration into the next)."""
    c = case_f32
    lidf_m, ref = c.port_models()
    inp = lidf.prepare_inputs(lidf_m.static, c.tbatch(), train=True,
                              generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        out = lidf_m.eval()(inp)

    def grads(cut):
        ref.zero_grad(set_to_none=True)
        pred = ref(inp, out, out["pred_pos"])
        pred = ref(inp, out, pred.detach() if cut else pred)
        refine_loss(inp, pred, train=True, img_hw=(H, W))["loss_net"].backward()
        return {n: p.grad.clone() for n, p in ref.named_parameters()}

    full, cut = grads(False), grads(True)
    assert any(not torch.equal(full[n], cut[n]) for n in full)


# -- eval and vis steps -----------------------------------------------------------

def _eval_run(c, use_all_pix):
    """Both packages' refine eval step on one frame, every pixel a ray."""
    over = {**tiny_overrides("float32"), "refine": {
        "pnet_out": 16, "pnet_gf": 8, "imnet_gf": 8,
        "use_all_pix": use_all_pix}}
    jcfg = jax_load_config(overrides=over)
    jstatic = jax_build_static(jcfg, n_rays=H * W)
    jl, jr = jax_build_lidf(jcfg, jstatic), jax_build_refine(jcfg, jstatic)
    raw = synthetic_batch(47, 1, H, W)
    tx = jstate.make_optimizer("adam", 1e-3)
    jst = jstate.TrainState.create(c.rparams, {}, tx)
    jin, jout, jpred, jlosses = jsteps.make_refine_eval_step(jcfg, jl, jr)(
        jst, c.lvars, {k: jnp.asarray(v) for k, v in raw.items()},
        jax.random.key(4))
    cfg = load_config(overrides=over)
    static = build_static(cfg, n_rays=H * W)
    lidf_m = lidf_from_jax(c.lvars, build_lidf(cfg, static))
    ref = refine_from_jax(c.rparams, build_refine(cfg, static))
    state = TrainState.create(ref, cfg.training, steps_per_epoch=10)
    _, out, pred, losses = make_refine_eval_step(cfg, lidf_m, ref, "cpu")(
        state, {k: T(v) for k, v in raw.items()},
        valid_idx=T(jin["valid_idx"]))
    assert not ref.training and not lidf_m.training
    return {"jax": (jout, jpred, jlosses), "port": (out, pred, losses)}


@pytest.fixture(scope="module")
def eval_runs(case_f32):
    return {flag: _eval_run(case_f32, flag) for flag in (True, False)}


@pytest.mark.parametrize("use_all_pix", [True, False])
def test_refine_eval_step_matches_jax(eval_runs, use_all_pix):
    (jout, jpred, jlosses), (out, pred, losses) = (
        eval_runs[use_all_pix]["jax"], eval_runs[use_all_pix]["port"])
    np.testing.assert_array_equal(out["max_slot"].numpy(),
                                  np.asarray(jout["max_slot"]))
    assert set(losses) == set(jlosses)
    for k in jlosses:
        np.testing.assert_allclose(N(losses[k]), np.asarray(jlosses[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    # 1e-4: f32 algebra through both stages, in another order
    np.testing.assert_allclose(N(pred), np.asarray(jpred), atol=1e-4, rtol=0)


def test_use_all_pix_changes_what_the_refine_sees(eval_runs):
    """The injection mask of ``use_all_pix: false`` is live: it changes the
    refined points of a frame with input depth, in both packages."""
    for side, k in (("jax", 1), ("port", 1)):
        a, b = (np.asarray(eval_runs[f][side][k], np.float32)
                for f in (True, False))
        assert np.abs(a - b).max() > 1e-4, side


def test_vis_steps_match_jax(case_f32):
    c = case_f32
    tx = jstate.make_optimizer("adam", 1e-3)
    key = jax.random.key(6)
    jin, jpred = jsteps.make_lidf_vis_step(c.jcfg, c.jlidf)(
        jstate.TrainState.create(c.lvars["params"], c.lvars["batch_stats"],
                                 tx), c.batch, key)
    jin_r, jrefined = jsteps.make_refine_vis_step(c.jcfg, c.jlidf, c.jref)(
        jstate.TrainState.create(c.rparams, {}, tx), c.lvars, c.batch, key)
    lidf_m, ref = c.port_models()
    draws = dict(valid_idx=T(jin["valid_idx"]), miss_start=T(jin["miss_start"]))
    _, pred = make_lidf_vis_step(c.cfg, lidf_m, "cpu")(None, c.tbatch(), None,
                                                       **draws)
    _, refined = make_refine_vis_step(c.cfg, lidf_m, ref, "cpu")(
        None, c.tbatch(), None, **draws)
    # 1e-4: f32 algebra through the model(s), in another order
    np.testing.assert_allclose(N(pred), np.asarray(jpred), atol=1e-4, rtol=0)
    np.testing.assert_allclose(N(refined), np.asarray(jrefined), atol=1e-4,
                               rtol=0)
    assert np.abs(N(refined) - N(pred)).max() > 1e-3


@pytest.mark.parametrize("factory", [make_refine_train_step,
                                     make_refine_eval_step,
                                     make_refine_vis_step])
def test_refine_steps_default_to_the_card_and_raise_without_one(factory,
                                                                 monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = load_config(overrides=tiny_overrides("float32"))
    static = build_static(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        factory(cfg, build_lidf(cfg, static), build_refine(cfg, static))


def test_pointnet_split_shares_a_tied_maximum_as_jax():
    """``call_split`` combines its parts with torch.maximum, whose gradient
    gives each side half on a tie, as jnp.maximum does (stage 2's parts tie
    at 0 in every cell no prediction reaches)."""
    a = np.array([0.0, 1.0, 2.0, 0.5], np.float32)
    b = np.array([0.0, 0.5, 2.0, 3.0], np.float32)
    ja, jb = jax.grad(lambda x, y: jnp.sum(jnp.maximum(x, y) * jnp.arange(
        1.0, 5.0)), argnums=(0, 1))(a, b)
    ta, tb = T(a).requires_grad_(), T(b).requires_grad_()
    (torch.maximum(ta, tb) * torch.arange(1.0, 5.0)).sum().backward()
    np.testing.assert_array_equal(N(ta.grad), np.asarray(ja))
    np.testing.assert_array_equal(N(tb.grad), np.asarray(jb))


@pytest.mark.parametrize("name,path", [
    ("REFINE_OVERRIDES", "configs/train_refine.yaml"),
    ("REFINE_HARDNEG_OVERRIDES", "configs/train_refine_hardneg.yaml")])
def test_smoke_stage2_settings_are_the_configs(name, path):
    """chip_smoke.py trains stage 2 with the settings of the stage-2 config
    files, copied because the card's machine has no pyyaml: every section
    the port's training reads is the file's."""
    import importlib.util
    import pathlib

    repo = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  repo / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    want = load_config(str(repo / path)).to_dict()
    got = load_config(overrides=getattr(smoke, name)).to_dict()
    for section in ("mask_type", "model", "refine", "training", "loss", "tpu"):
        assert got[section] == want[section], section
