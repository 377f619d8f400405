"""The model and optimizer options the port's first slices refused, against
the JAX package on the CPU: the IMNet offset decoder and ``pos_encode:
false`` in both stages and all three decode modes (forward outputs and
``jax.grad`` gradients), ``tpu.remat_backbone`` (bit for bit the step
without it, and JAX's remat step within the step tolerances), the
``lbfgs`` optimizer against ``optax.lbfgs(linesearch=None)``, and the
exact ``roi_align`` against JAX's.

Tolerances: f32 those of ``test_torch_port_train.py`` and
``test_torch_port_refine_train.py``, one algebra summed in another order
(1e-4 of a tensor's largest value for gradients and positions, 1e-5 for
the refine losses); bf16 per group of parameters
(``OPTION_BF16_GRAD_LIMITS``); the others as each case states. Per-ray
cases run at K=12 > kb=8, so that JAX takes its per_ray decode.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_port_refine_train import (
    _inside_the_clamp,
    _jax_refine_step,
)
from test_torch_port_refine_train import tiny_overrides as refine_overrides
from test_torch_port_train import (
    N,
    T,
    _jax_step,
    _leaves,
    assert_rel_max,
    randomize,
)

from implicit_depth_tpu.builder import build_lidf as jax_build_lidf
from implicit_depth_tpu.builder import build_refine as jax_build_refine
from implicit_depth_tpu.builder import build_static as jax_build_static
from implicit_depth_tpu.config import load_config as jax_load_config
from implicit_depth_tpu.models import lidf as jlidf
from implicit_depth_tpu.ops.roi_align import roi_align as jax_roi_align
from implicit_depth_tpu.ops.roi_align import roi_window_pool as jax_window_pool
from implicit_depth_tpu.train import state as jstate
from implicit_depth_torch.builder import build_lidf, build_refine, build_static
from implicit_depth_torch.config import load_config
from implicit_depth_torch.data.synthetic import synthetic_batch
from implicit_depth_torch.models import lidf as port_lidf
from implicit_depth_torch.models import refine as port_refine
from implicit_depth_torch.ops.roi_align import roi_align, roi_window_pool
from implicit_depth_torch.train.state import (
    LBFGS,
    TrainState,
    make_optimizer,
    step_lr,
)
from implicit_depth_torch.train.steps import (
    make_lidf_train_step,
    make_refine_train_step,
)
from implicit_depth_torch.weights import (
    lidf_from_jax,
    lidf_grads_from_jax,
    refine_from_jax,
    refine_grads_from_jax,
    resnet_batch_stats,
)

torch.set_num_threads(2)
# a first torch.sin before any JAX computation (see test_torch_port_ops.py)
torch.sin(torch.zeros(1 << 16))
H, W = 48, 64

OPTIONS = {"imnet": {"model": {"offdec_type": "IMNET"},
                     "refine": {"offdec_type": "IMNET"}},
           "no_posenc": {"model": {"pos_encode": False},
                         "refine": {"pos_encode": False}}}
# per_ray: kb 8 of K 12; global at budget 1, which drops pairs; dense
MODES = {"per_ray": {},
         "global": {"pairs_budget_mode": "global", "pairs_budget_per_ray": 1},
         "dense": {"pairs_budget_per_ray": 0}}


def overrides(option, mode, dtype="float32", **tpu):
    """The tiny model's overrides with ``option`` (a name of OPTIONS, or
    its own {section: values}) in ``mode``."""
    out = copy.deepcopy(refine_overrides(dtype))
    sections = option if isinstance(option, dict) else OPTIONS.get(option, {})
    for section, vals in sections.items():
        out[section] = {**out[section], **vals}
    out["tpu"].update(MODES[mode], **tpu)
    return out


class Case:
    """JAX and port stage-1 and stage-2 models of ``option`` in ``mode``
    with the same randomized weights, and a training batch of 2 images
    (the attributes ``_jax_refine_step`` reads)."""

    def __init__(self, option, mode, dtype="float32", seed=44, **tpu):
        o = overrides(option, mode, dtype, **tpu)
        self.jcfg = jax_load_config(overrides=o)
        self.cfg = load_config(overrides=o)
        self.jstatic = jax_build_static(self.jcfg)
        self.jlidf = jax_build_lidf(self.jcfg, self.jstatic)
        self.jref = jax_build_refine(self.jcfg, self.jstatic)
        self.raw = synthetic_batch(seed, 2, H, W)
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

    def port_models(self):
        static = build_static(self.cfg)
        return (lidf_from_jax(self.lvars, build_lidf(self.cfg, static)),
                refine_from_jax(self.rparams, build_refine(self.cfg, static)))

    def tbatch(self):
        return {k: T(v) for k, v in self.raw.items()}


_CASES = {}


def case(option, mode, dtype="float32"):
    key = (option, mode, dtype)
    if key not in _CASES:
        _CASES[key] = Case(option, mode, dtype)
    return _CASES[key]


def no_kernels(monkeypatch):
    """Every kernel wrapper the models call, made to raise: the options'
    decode must not reach one."""
    def refuse(*a, **kw):
        raise AssertionError("a kernel wrapper was called")
    for mod, names in ((port_lidf, ("ray_decode", "ray_decode_train",
                                    "pair_decode")),
                       (port_refine, ("ief_decode", "ief_decode_train"))):
        for name in names:
            monkeypatch.setattr(mod, name, refuse)


CASES = [(o, m) for o in OPTIONS for m in MODES]


@pytest.mark.parametrize("option,mode", CASES)
def test_options_build_the_decoders_jax_builds(option, mode):
    c = case(option, mode)
    lm, rm = c.port_models()
    want = "IEF" if option == "no_posenc" else "IMNet"
    assert type(lm.offset_dec).__name__ == want
    assert type(rm.offset_dec).__name__ == want
    assert not lm.fused and not rm.fused
    assert lm.decode_mode == mode
    # every parameter of the JAX trees has a place (lidf_from_jax raises on
    # a width that does not fit): the same count of parameters
    n_jax = sum(np.size(v) for _, v in _leaves(c.lvars["params"]))
    assert sum(p.numel() for p in lm.parameters()) == n_jax


@pytest.mark.parametrize("option,mode", CASES)
def test_options_stage1_train_step_matches_jax_grad(option, mode,
                                                    monkeypatch):
    """f32, epoch 10 (the predicted slot): the losses, every gradient within
    1e-4 of its largest value (plus 1e-7), the new running statistics; no
    kernel wrapper reached."""
    c = case(option, mode)
    no_kernels(monkeypatch)
    jin, jgrads, jlosses, jstats = _jax_step(c.jcfg, c.jstatic, c.jlidf,
                                             c.lvars, c.raw, 10)
    model = c.port_models()[0]
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
    got_stats = resnet_batch_stats(model.resnet)
    for path, node in _leaves(jstats["resnet"]):
        g = got_stats
        for key in path:
            g = g[key]
        assert_rel_max(g, node, 1e-4, "/".join(path))


@pytest.mark.parametrize("option,mode", CASES)
def test_options_stage1_eval_matches_jax(option, mode, monkeypatch):
    """The eval forward of every pixel: the slots and the decoded pairs
    exactly, the logits (1e-4 of their largest value), the predicted
    positions (1e-4 m)."""
    c = case(option, mode)
    no_kernels(monkeypatch)
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
    assert out["prob_logit"].shape == jout["prob_logit"].shape
    np.testing.assert_array_equal(N(out["max_slot"]),
                                  np.asarray(jout["max_slot"]))
    np.testing.assert_array_equal(N(out["pair_valid"]),
                                  np.asarray(jout["pair_valid"]))
    assert_rel_max(N(out["prob_logit"]), np.asarray(jout["prob_logit"]),
                   1e-4, "prob_logit")
    np.testing.assert_allclose(N(out["pred_pos"]),
                               np.asarray(jout["pred_pos"]), atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("option,mode", CASES)
def test_options_stage2_train_step_matches_jax_grad(option, mode,
                                                    monkeypatch):
    """f32, epoch 10: the refine step's losses within 1e-5, every refine
    gradient within 1e-4 of its largest value (plus 1e-7); no kernel
    wrapper reached."""
    c = case(option, mode)
    no_kernels(monkeypatch)
    jin, jgrads, jlosses, noise = _jax_refine_step(c, 10)
    lidf_m, ref = c.port_models()
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
        assert (p.grad != 0).any(), f"{name}: zero gradient"
        assert_rel_max(N(p.grad), N(want[name]), 1e-4, name, atol=1e-7)


# bf16: each group's gradients against JAX's bf16 gradients, by the relative
# norm of the difference over the whole group (readings at seed 44, epoch
# 0, IMNet / no posenc: ResNet 0.077 / 0.104, PointNet 0.014 / 0.071,
# offset decoder 0.010 / 0.012, probability decoder 0.056 / 0.142). Per
# tensor the ratios run higher where a gradient nearly cancels (the
# probability decoder's last bias, 3e-5; without posenc the first voxel
# MLP's bias, 1.8e-3): the groups' norms hold the comparison instead.
# Limits about twice the readings.
OPTION_BF16_GRAD_LIMITS = {"resnet": 0.2, "pnet": 0.15, "offset_dec": 0.03,
                           "prob_dec": 0.3}


@pytest.mark.parametrize("option", list(OPTIONS))
def test_options_bf16_stage1_step_matches_jax_grad(option):
    """bf16 per_ray, epoch 0: JAX compiled with ``xla_allow_excess_precision``
    off, as ``test_train_step_matches_jax_grad``; the losses within 2e-2
    relative (the slot accuracy, a count of argmax agreements, within 0.05:
    bf16 near-ties moved 8 of 282 rays without posenc); each group's
    gradients within ``OPTION_BF16_GRAD_LIMITS``."""
    c = case(option, "per_ray", "bfloat16")
    jin, jgrads, jlosses, _ = _jax_step(
        c.jcfg, c.jstatic, c.jlidf, c.lvars, c.raw, 0,
        {"xla_allow_excess_precision": False})
    model = c.port_models()[0]
    state = TrainState.create(model, c.cfg.training, steps_per_epoch=10)
    losses = make_lidf_train_step(c.cfg, model, "cpu")(
        state, c.tbatch(), None, 0, valid_idx=T(jin["valid_idx"]),
        miss_start=T(jin["miss_start"]))
    for k in jlosses:
        kw = dict(rtol=0, atol=0.05) if k == "acc" else dict(rtol=2e-2,
                                                               atol=1e-3)
        np.testing.assert_allclose(N(losses[k]), np.asarray(jlosses[k]),
                                   err_msg=k, **kw)
    want = lidf_grads_from_jax(jgrads, model)
    params = dict(model.named_parameters())
    for group, limit in OPTION_BF16_GRAD_LIMITS.items():
        names = [n for n in params if n.split(".")[0] == group]
        got = np.concatenate([N(params[n].grad).ravel() for n in names])
        ref = np.concatenate([N(want[n]).ravel() for n in names])
        err = np.linalg.norm(got - ref) / np.linalg.norm(ref)
        assert err <= limit, f"{group}: {err:.3g}"


def test_ief_with_posenc_keeps_the_kernel_path():
    """The default decoder still decodes through the kernel wrappers (their
    plain versions on the CPU): the config alone selects the path."""
    cfg = load_config(overrides=overrides("ief", "per_ray"))
    static = build_static(cfg, n_rays=H * W)
    lm = build_lidf(cfg, static).eval()
    rm = build_refine(cfg, static).eval()
    assert lm.fused and rm.fused


# -- remat --------------------------------------------------------------------

def _remat_step(c, remat, epoch=10):
    """The port's f32 stage-1 step with ``remat_backbone`` as given: the
    parameters' gradients and the new running statistics."""
    cfg = copy.deepcopy(c.cfg)
    cfg.tpu.remat_backbone = remat
    model = lidf_from_jax(c.lvars, build_lidf(cfg, build_static(cfg)))
    assert model.remat_backbone == remat
    state = TrainState.create(model, cfg.training, steps_per_epoch=10)
    jin = c.jin
    losses = make_lidf_train_step(cfg, model, "cpu")(
        state, c.tbatch(), None, epoch, valid_idx=T(jin["valid_idx"]),
        miss_start=T(jin["miss_start"]))
    return (losses, {n: p.grad.clone() for n, p in model.named_parameters()},
            {k: v.clone() for k, v in model.state_dict().items()})


@pytest.fixture(scope="module")
def remat_case():
    c = case("ief", "per_ray")
    c.jin = _jax_step(c.jcfg, c.jstatic, c.jlidf, c.lvars, c.raw, 10)[0]
    return c


def test_remat_backbone_is_bit_for_bit_the_step_without_it(remat_case):
    """Gradients, running statistics (moved once, not twice) and the
    updated parameters: the bits of the step without remat."""
    l0, g0, s0 = _remat_step(remat_case, False)
    l1, g1, s1 = _remat_step(remat_case, True)
    for k in l0:
        assert torch.equal(l0[k], l1[k]), k
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name
    for k in s0:
        assert torch.equal(s0[k], s1[k]), k
    # the running statistics moved from the loaded ones exactly once
    before = lidf_from_jax(remat_case.lvars, build_lidf(
        remat_case.cfg, build_static(remat_case.cfg))).state_dict()
    k = "resnet.bn1.running_mean"
    assert not torch.equal(s1[k], before[k])


def test_remat_backbone_matches_jax_remat_grad(remat_case):
    """JAX with ``remat_backbone: true`` against the port with it: the f32
    step tolerances of ``test_train_step_matches_jax_grad``."""
    c = remat_case
    jcfg = copy.deepcopy(c.jcfg)
    jcfg.tpu.remat_backbone = True
    jmodel = jax_build_lidf(jcfg, c.jstatic)
    jin, jgrads, jlosses, jstats = _jax_step(jcfg, c.jstatic, jmodel,
                                             c.lvars, c.raw, 10)
    losses, grads, sd = _remat_step(c, True)
    for k in jlosses:
        np.testing.assert_allclose(N(losses[k]), np.asarray(jlosses[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    model = build_lidf(c.cfg, build_static(c.cfg))
    want = lidf_grads_from_jax(jgrads, model)
    for name in want:
        assert_rel_max(N(grads[name]), N(want[name]), 1e-4, name, atol=1e-7)
    model.load_state_dict(sd)
    got_stats = resnet_batch_stats(model.resnet)
    for path, node in _leaves(jstats["resnet"]):
        g = got_stats
        for key in path:
            g = g[key]
        assert_rel_max(g, node, 1e-4, "/".join(path))


def test_remat_is_the_plain_call_without_autograd(remat_case):
    c = remat_case
    cfg = copy.deepcopy(c.cfg)
    cfg.tpu.remat_backbone = True
    static = build_static(cfg, n_rays=H * W)
    a = lidf_from_jax(c.lvars, build_lidf(cfg, static)).eval()
    b = lidf_from_jax(c.lvars, build_lidf(c.cfg, static)).eval()
    with torch.no_grad():
        inp = port_lidf.prepare_inputs(static, c.tbatch(),
                                       generator=torch.Generator()
                                       .manual_seed(0))
        oa, ob = a(inp), b(inp)
    assert torch.equal(oa["pred_pos"], ob["pred_pos"])


# -- lbfgs --------------------------------------------------------------------

def _lbfgs_run(params0, grads, jsched, sched, memory=10):
    """optax.lbfgs(linesearch=None) and the port's, each step's gradients
    ``grads(i, params)`` ({name: array}) of optax's parameters, fed to
    both: each step's parameters, both sides."""
    tx = jstate.make_optimizer("lbfgs", jsched)
    jp = {k: jnp.asarray(v) for k, v in params0.items()}
    st = tx.init(jp)
    params = {k: torch.nn.Parameter(T(v)) for k, v in params0.items()}
    opt = make_optimizer("lbfgs", params.values(), sched)
    assert isinstance(opt, LBFGS) and opt.memory == memory
    state = TrainState(model=None, optimizer=opt, lr=sched)
    out = []
    for i in range(3):
        g = grads(i, {k: np.asarray(v) for k, v in jp.items()})
        upd, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in params.items():
            p.grad = T(g[k])
        state.apply_gradients()
        out.append(({k: N(p).copy() for k, p in params.items()},
                    {k: np.asarray(v) for k, v in jp.items()}))
    return out, state


def _quadratic(params0, seed):
    """Gradients of a quadratic with a diagonal curvature in [0.5, 2]
    around a target one unit away, plus noise: ``grads(i, params)``."""
    rng = np.random.default_rng(seed)
    curv = {k: rng.uniform(0.5, 2.0, v.shape) for k, v in params0.items()}
    target = {k: v + rng.normal(size=v.shape) for k, v in params0.items()}
    noise = [{k: 0.01 * rng.normal(size=v.shape) for k, v in params0.items()}
             for _ in range(3)]

    def grads(i, p):
        return {k: (curv[k] * (p[k] - target[k]) + noise[i][k]).astype(
            np.float32) for k in p}
    return grads


def lbfgs_f64(history, g, memory=10):
    """optax's L-BFGS direction in float64 from the f32 parameters and
    gradients of each step so far (``history``: [(w, g), ...], this step's
    w last) and this step's gradient ``g``."""
    pairs = [(history[i + 1][0] - history[i][0],
              history[i + 1][1] - history[i][1])
             for i in range(len(history) - 1)][-memory:]
    if not pairs:
        return g / max(1.0, np.linalg.norm(g))
    rhos = [1.0 / du.dot(dw) for dw, du in pairs]
    q, alphas = g.copy(), []
    for (dw, du), rho in zip(reversed(pairs), reversed(rhos)):
        alphas.append(rho * dw.dot(q))
        q -= alphas[-1] * du
    dw, du = pairs[-1]
    q *= du.dot(dw) / du.dot(du)
    for (dw, du), rho, a in zip(pairs, rhos, reversed(alphas)):
        q += (a - rho * du.dot(q)) * dw
    return q


def test_lbfgs_matches_optax_on_a_small_lidf_model():
    """Three steps over the small LIDF model's PointNet and decoder
    parameters (14,298, the ResNet left out), through ``make_optimizer``
    with a StepLR schedule at rate 1 that drops 10x after two updates, both
    optimizers fed the gradients of a quadratic at optax's parameters:
    every parameter within 1e-5 of the largest distance travelled from the
    start (measured up to 3.2e-6 of it), where each step moves them by more
    than 1e-3. (Over the whole model's 4.9 M parameters optax's f32 inner
    products sum in one f32 accumulator, and its update lands 2.9e-2 from
    the float64 two-loop's at step 2; the next case holds the port to
    float64 there.)"""
    c = case("ief", "per_ray")
    params0 = {n: N(p).copy() for n, p in
               c.port_models()[0].named_parameters()
               if not n.startswith("resnet.")}
    assert 5000 < sum(v.size for v in params0.values()) < 20000
    steps, _ = _lbfgs_run(params0, _quadratic(params0, 47),
                          jstate.step_lr(1.0, 1, 2, 0.1),
                          step_lr(1.0, 1, 2, 0.1))
    last = params0
    for i, (got, want) in enumerate(steps):
        moved = max(np.abs(want[k] - last[k]).max() for k in got)
        assert moved > 1e-3, (i, moved)
        travelled = max(np.abs(want[k] - params0[k]).max() for k in got)
        err = max(np.abs(got[k] - want[k]).max() for k in got)
        assert err <= 1e-5 * travelled, (i, err, travelled)
        last = want


def test_lbfgs_on_the_whole_small_model_matches_float64():
    """Three steps over all 4.9 M parameters of the small LIDF model: each
    step's move of the parameters within 1e-3 of its largest value of the
    float64 two-loop's update from the same f32 parameters and gradients
    (measured up to 1.3e-4 of it, at the first step: a move of g/‖g‖,
    read back from f32 parameters that round at their ulp)."""
    c = case("ief", "per_ray")
    model = c.port_models()[0]
    params = [p for p in model.parameters()]
    keys = [n for n, _ in model.named_parameters()]
    grads = _quadratic({n: N(p).copy() for n, p in model.named_parameters()},
                       51)
    opt = make_optimizer("lbfgs", params, 1.0)
    state = TrainState(model=model, optimizer=opt, lr=1.0)
    history = []
    for i in range(3):
        w = {n: N(p).copy() for n, p in zip(keys, params)}
        g = grads(i, w)
        for n, p in zip(keys, params):
            p.grad = T(g[n])
        flat_w = np.concatenate([w[n].ravel() for n in keys]).astype(float)
        flat_g = np.concatenate([g[n].ravel() for n in keys]).astype(float)
        history.append((flat_w, flat_g))
        want = -lbfgs_f64(history, flat_g)
        state.apply_gradients()
        got = np.concatenate([N(p).ravel() for p in params]) - flat_w
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= 1e-3 * scale, (i, scale)


def test_lbfgs_minimises_the_quadratic():
    """``tests/test_state.py``'s case: the curvature pairs make the
    direction Newton-exact on a quadratic."""
    w = torch.nn.Parameter(torch.tensor([3.0, -2.0]))
    state = TrainState(model=None,
                       optimizer=make_optimizer("lbfgs", [w], 1.0), lr=1.0)
    for _ in range(5):
        w.grad = 2 * w.detach()
        state.apply_gradients()
    assert float((w.detach() ** 2).sum()) < 1e-6


def test_lbfgs_state_dict_resumes_bit_for_bit():
    """Two steps, the state through ``state_dict`` into a fresh optimizer
    over other parameter objects, two more: the bits of four steps
    uninterrupted; a state of another optimizer does not fit."""
    from implicit_depth_torch.train.checkpoint import _opt_state_fits
    rng = np.random.default_rng(48)
    p0 = {"a": rng.normal(size=(5, 3)).astype(np.float32),
          "b": rng.normal(size=(7,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in p0.items()} for _ in range(4)]

    def fresh():
        params = {k: torch.nn.Parameter(T(v)) for k, v in p0.items()}
        return params, TrainState(model=None, optimizer=make_optimizer(
            "lbfgs", params.values(), 0.1), lr=0.1)

    def steps(params, state, gs):
        for g in gs:
            for k, p in params.items():
                p.grad = T(g[k])
            state.apply_gradients()

    pa, sa = fresh()
    steps(pa, sa, grads)
    pb, sb = fresh()
    steps(pb, sb, grads[:2])
    saved = copy.deepcopy(sb.optimizer.state_dict())
    pc, sc = fresh()
    with torch.no_grad():
        for k in pc:
            pc[k].copy_(pb[k])
    assert _opt_state_fits(sc.optimizer, saved)
    sc.optimizer.load_state_dict(saved)
    steps(pc, sc, grads[2:])
    for k in pa:
        assert torch.equal(pa[k], pc[k]), k
    adam = make_optimizer("adam", [torch.nn.Parameter(T(v)) for v in
                                   p0.values()], 0.1)
    assert not _opt_state_fits(adam, saved)
    assert not _opt_state_fits(sc.optimizer, adam.state_dict())


# -- roi_align ----------------------------------------------------------------

def _boxes():
    """``tests/test_roi_align.py``'s boxes: interior, at the border, clipped
    and degenerate (x1 == x2 at the image corner)."""
    boxes, batches = [], []
    for px, py in [(16, 12), (3, 12), (16, 1), (31, 23), (0, 0), (10, 20)]:
        x1, y1 = np.clip(px - 4, 0, 31), np.clip(py - 4, 0, 23)
        x2, y2 = np.clip(px + 4, 0, 31), np.clip(py + 4, 0, 23)
        boxes.append([x1, y1, x2, y2])
        batches.append(len(batches) % 2)
    boxes.append([5.0, 5.0, 5.0, 9.0])  # zero width
    batches.append(0)
    return np.asarray(boxes, np.float32), np.asarray(batches, np.int32)


@pytest.mark.parametrize("kw", [{}, {"sampling_ratio": 2},
                                {"aligned": False}, {"output_size": 3}])
def test_roi_align_matches_jax(kw):
    """Every box and option within 1e-6 of JAX (the same bilinear weights in
    f32, summed in another order)."""
    rng = np.random.default_rng(49)
    feat = rng.normal(size=(2, 24, 32, 3)).astype(np.float32)
    boxes, batches = _boxes()
    want = np.asarray(jax_roi_align(jnp.asarray(feat), jnp.asarray(boxes),
                                    jnp.asarray(batches), **kw))
    got = roi_align(T(feat), T(boxes), T(batches), **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(N(got), want, atol=1e-6, rtol=0)


def test_window_pool_is_roi_align_on_interior_pixels():
    """On pixels whose 8x8 box lies inside the image the window pool is the
    exact ROIAlign (1e-5: a 16-term mean against bilinear sums)."""
    rng = np.random.default_rng(50)
    feat = rng.normal(size=(1, 24, 32, 5)).astype(np.float32)
    pix = np.asarray([[16, 12], [5, 7], [27, 19], [4, 4]], np.int32)
    bidx = np.zeros(4, np.int32)
    boxes = np.concatenate([pix - 4, pix + 4], -1).astype(np.float32)
    exact = roi_align(T(feat), T(boxes), T(bidx))
    pooled = roi_window_pool(T(feat), T(pix), T(bidx))
    np.testing.assert_allclose(N(pooled), N(exact), atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        N(pooled), np.asarray(jax_window_pool(jnp.asarray(feat),
                                              jnp.asarray(pix),
                                              jnp.asarray(bidx))),
        atol=1e-6, rtol=0)
