"""The eval steps with ``tpu.eval_rays_per_chunk`` against the JAX package's,
on the CPU.

Stage 1 (``make_lidf_eval_step``): with a chunk below the frame's ray count
the trunk runs once and the per-ray decode over chunks of rays (the last
padded, the padding cut), as JAX's ``_chunked_forward`` does; at or above
the ray count, one shot. Each case is held against JAX's eval step at the
same chunk, and the port's chunked outputs against its own one-shot
outputs bit for bit. Stage 2 (``make_refine_eval_step``): JAX never reads
the key, and the port, given it, evaluates as JAX does.

Shapes of the JAX package's ``tests/test_parallel.py`` chunked-eval case
(48x64, every pixel a ray, 1000 rays a chunk so that the last one is
padded), with K = 12 pair slots over kb = 8 so that both packages take the
per_ray decode.
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
from implicit_depth_tpu.train import state as jstate
from implicit_depth_tpu.train import steps as jsteps
from implicit_depth_torch.builder import build_lidf, build_refine, build_static
from implicit_depth_torch.config import load_config
from implicit_depth_torch.data.synthetic import synthetic_batch
from implicit_depth_torch.train.state import TrainState
from implicit_depth_torch.train.steps import (
    make_lidf_eval_step,
    make_refine_eval_step,
)
from implicit_depth_torch.weights import lidf_from_jax, refine_from_jax

torch.set_num_threads(2)
# warm up the CPU sin before any XLA computation (see test_torch_port_ops.py)
torch.sin(torch.zeros(1 << 16))

H, W = 48, 64
R = H * W  # rays of a frame, every pixel a ray


def overrides(chunk):
    return {
        "mask_type": "all",
        "dataset": {"img_height": H, "img_width": W},
        "model": {"rgb_out": 8, "pnet_out": 16, "pnet_gf": 8, "imnet_gf": 8,
                  "resnet_stages": [1, 1, 1, 1]},
        "refine": {"pnet_out": 16, "pnet_gf": 8, "imnet_gf": 8},
        "grid": {"res": 8, "valid_sample_num": 128},
        "tpu": {"max_pairs_per_ray": 12, "pairs_budget_per_ray": 8,
                "use_pallas_decode": False, "compute_dtype": "float32",
                "eval_rays_per_chunk": chunk},
    }


def T(a):
    return torch.from_numpy(np.array(a))


def N(t):
    return t.float().numpy()


def _randomize(tree, rng):
    """Every leaf redrawn at O(1) activation scale, each decoder's output
    inside the soft clamp (as the other port tests draw them)."""
    if isinstance(tree, dict):
        return {k: _randomize(v, rng) for k, v in tree.items()}
    a = np.asarray(tree)
    return (0.1 + 0.3 * rng.normal(size=a.shape)).astype(np.float32) \
        if a.ndim == 1 else (rng.normal(size=a.shape) / np.sqrt(
            np.prod(a.shape[:-1]))).astype(np.float32)


def _inside_the_clamp(params, n_iter):
    for dec, bias in (("offset_dec", 0.5 / n_iter), ("prob_dec", 0.5)):
        if dec in params:
            last = params[dec]["_MLP4_0"]["Dense_3"]
            last["kernel"] = last["kernel"] * 0.25
            last["bias"] = np.full_like(last["bias"], bias)


@pytest.fixture(scope="module")
def models():
    """JAX stage-1 variables and stage-2 parameters, randomized, built at
    the frame's ray count, and the frame."""
    jcfg = jax_load_config(overrides=overrides(0))
    jstatic = jax_build_static(jcfg, n_rays=R)
    jl, jr = jax_build_lidf(jcfg, jstatic), jax_build_refine(jcfg, jstatic)
    raw = synthetic_batch(53, 1, H, W)
    batch = {k: jnp.asarray(v) for k, v in raw.items()}
    jin = jax.jit(lambda b, k: jlidf.prepare_inputs(jstatic, b, k,
                                                    train=False))(
        batch, jax.random.key(0))
    rng = np.random.default_rng(53)
    lv = jax.device_get(jax.jit(lambda k, i: jl.init(
        k, i, train=False, use_gt_label=False))(jax.random.key(1), jin))
    lvars = {"params": _randomize(lv["params"], rng),
             "batch_stats": jax.tree.map(
                 lambda a: (0.5 + 0.5 * np.abs(rng.normal(size=a.shape)))
                 .astype(np.float32), lv["batch_stats"])}
    _inside_the_clamp(lvars["params"], jcfg.model.n_iter)
    lout = jax.jit(lambda v, i: jl.apply(v, i, train=False,
                                         use_gt_label=False))(lvars, jin)
    rv = jax.device_get(jax.jit(lambda k, i, o: jr.init(
        k, i, o, o["pred_pos"]))(jax.random.key(2), jin, lout))
    rparams = _randomize(rv["params"], rng)
    _inside_the_clamp(rparams, jcfg.refine.n_iter)
    return {"lvars": lvars, "rparams": rparams, "raw": raw}


def _port_lidf(m, cfg):
    return lidf_from_jax(m["lvars"], build_lidf(cfg, build_static(cfg,
                                                                  n_rays=R)))


def _jax_lidf_eval(m, chunk):
    jcfg = jax_load_config(overrides=overrides(chunk))
    jl = jax_build_lidf(jcfg, jax_build_static(jcfg, n_rays=R))
    tx = jstate.make_optimizer("adam", 1e-3)
    st = jstate.TrainState.create(m["lvars"]["params"],
                                  m["lvars"]["batch_stats"], tx)
    return jsteps.make_lidf_eval_step(jcfg, jl)(
        st, {k: jnp.asarray(v) for k, v in m["raw"].items()},
        jax.random.key(3))


def _port_lidf_eval(m, chunk, valid_idx):
    cfg = load_config(overrides=overrides(chunk))
    model = _port_lidf(m, cfg)
    state = TrainState.create(model, cfg.training, steps_per_epoch=10)
    return make_lidf_eval_step(cfg, model, "cpu")(
        state, {k: T(v) for k, v in m["raw"].items()}, valid_idx=valid_idx)


@pytest.fixture(scope="module")
def one_shot(models):
    jin, _, _ = _jax_lidf_eval(models, 0)
    valid_idx = T(jin["valid_idx"])
    return valid_idx, _port_lidf_eval(models, 0, valid_idx)


# below the ray count (a padded last chunk); the ray count; above it
@pytest.mark.parametrize("chunk", [1000, R, R + 1000])
def test_chunked_lidf_eval_matches_jax_and_one_shot(models, one_shot, chunk):
    jin, jout, jl = _jax_lidf_eval(models, chunk)
    valid_idx, (_, out0, losses0) = one_shot
    _, out, losses = _port_lidf_eval(models, chunk, valid_idx)
    # against JAX at the same chunk: the tolerances of the one-shot
    # test_eval_step_matches_jax (f32 algebra in another order)
    np.testing.assert_array_equal(out["max_slot"].numpy(),
                                  np.asarray(jout["max_slot"]))
    np.testing.assert_allclose(N(out["pred_pos"]),
                               np.asarray(jout["pred_pos"]), atol=1e-4, rtol=0)
    np.testing.assert_allclose(N(out["prob_logit"]),
                               np.asarray(jout["prob_logit"]), atol=1e-4,
                               rtol=0)
    for k in jl:
        np.testing.assert_allclose(N(losses[k]), np.asarray(jl[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    # against the port's own one shot: the same bits, every output
    assert set(out) == set(out0)
    for k in out0:
        assert out[k].shape == out0[k].shape, k
        assert torch.equal(out[k], out0[k]), k
    for k in losses0:
        assert torch.equal(losses[k], losses0[k]), k


def test_chunked_lidf_eval_runs_the_decode_per_chunk(models, one_shot,
                                                     monkeypatch):
    """Below the ray count the decode runs once a chunk (ceil(R / chunk)
    times) on the trunk's one output; at or above it, once."""
    from implicit_depth_torch.models.lidf import LIDFModel
    calls = {"trunk": 0, "decode_rays": 0}
    for name in calls:
        orig = getattr(LIDFModel, name)

        def counted(self, *a, _orig=orig, _name=name, **kw):
            calls[_name] += 1
            return _orig(self, *a, **kw)
        monkeypatch.setattr(LIDFModel, name, counted)
    valid_idx = one_shot[0]
    for chunk, want in ((1000, 4), (R // 4, 4), (R, 1), (0, 1)):
        calls.update(trunk=0, decode_rays=0)
        _port_lidf_eval(models, chunk, valid_idx)
        assert calls == {"trunk": 1, "decode_rays": want}, chunk


def test_refine_eval_step_with_the_chunk_key_matches_jax(models):
    """JAX's refine eval step never reads tpu.eval_rays_per_chunk; the
    port's, given it, evaluates as JAX does (before, it raised
    NotImplementedError)."""
    m = models
    jcfg = jax_load_config(overrides=overrides(1000))
    jstatic = jax_build_static(jcfg, n_rays=R)
    jl, jr = jax_build_lidf(jcfg, jstatic), jax_build_refine(jcfg, jstatic)
    jst = jstate.TrainState.create(m["rparams"], {},
                                   jstate.make_optimizer("adam", 1e-3))
    jin, jout, jpred, jlosses = jsteps.make_refine_eval_step(jcfg, jl, jr)(
        jst, m["lvars"], {k: jnp.asarray(v) for k, v in m["raw"].items()},
        jax.random.key(4))
    cfg = load_config(overrides=overrides(1000))
    static = build_static(cfg, n_rays=R)
    lidf_m = lidf_from_jax(m["lvars"], build_lidf(cfg, static))
    ref = refine_from_jax(m["rparams"], build_refine(cfg, static))
    state = TrainState.create(ref, cfg.training, steps_per_epoch=10)
    _, out, pred, losses = make_refine_eval_step(cfg, lidf_m, ref, "cpu")(
        state, {k: T(v) for k, v in m["raw"].items()},
        valid_idx=T(jin["valid_idx"]))
    np.testing.assert_array_equal(out["max_slot"].numpy(),
                                  np.asarray(jout["max_slot"]))
    for k in jlosses:
        np.testing.assert_allclose(N(losses[k]), np.asarray(jlosses[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(N(pred), np.asarray(jpred), atol=1e-4, rtol=0)
