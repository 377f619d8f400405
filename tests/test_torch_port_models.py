"""The port's model parts against the JAX package's flax modules, on the CPU:
the flax variables (randomized to O(1) activations) are carried into the
port by ``implicit_depth_torch.weights`` and both run the same inputs."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from implicit_depth_tpu.models.imnet import IEF as JaxIEF
from implicit_depth_tpu.models.imnet import IMNet as JaxIMNet
from implicit_depth_tpu.models.pointnet import PointNet2Stage as JaxPointNet
from implicit_depth_tpu.models.resnet import ResNet34_8s as JaxResNet
from implicit_depth_torch.builder import (
    build_lidf,
    build_refine,
    build_static,
    randomize_weights_,
)
from implicit_depth_torch.config import load_config
from implicit_depth_torch.models.imnet import IEF, IMNet
from implicit_depth_torch.models.init import PreparedWeights
from implicit_depth_torch.models.pointnet import PointNet2Stage
from implicit_depth_torch.models.resnet import ResNet34_8s
from implicit_depth_torch.weights import load_mlp_decoder, load_pointnet, load_resnet

from test_torch_port_slice import randomize, tiny_overrides

torch.set_num_threads(2)


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("stages,out_ch", [((1, 1, 1, 1), 8), ((2, 1, 2, 1), 4)])
def test_resnet34_8s_matches(stages, out_ch):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1, 48, 64, 3)).astype(np.float32)
    jm = JaxResNet(out_ch=out_ch, stage_sizes=stages)
    variables = jax.jit(lambda k, v: jm.init(k, v, False))(jax.random.key(0), x)
    variables = randomize(jax.device_get(variables), rng)
    ref = jax.jit(lambda v, a: jm.apply(v, a, False))(variables, x)
    m = ResNet34_8s(out_ch=out_ch, stage_sizes=stages)
    load_resnet(m, variables["params"], variables["batch_stats"])
    with torch.no_grad():
        got = m.eval()(T(x))
    assert got.shape == (1, 48, 64, out_ch)
    # f32 convolutions summed in another order, through 4-6 blocks
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


@pytest.mark.parametrize("split", [False, True])
def test_pointnet2stage_matches(split):
    rng = np.random.default_rng(1)
    n, s = 400, 60
    inp = rng.normal(size=(n, 6)).astype(np.float32)
    seg = rng.integers(0, s, n).astype(np.int32)
    valid = rng.random(n) < 0.8
    jm = JaxPointNet(out_channels=16, gf_dim=8)
    params = jax.jit(lambda k, a, b, c: jm.init(k, a, b, s, c))(
        jax.random.key(0), inp, seg, valid)
    params = randomize(jax.device_get(params), rng)
    m = PointNet2Stage(out_channels=16, gf_dim=8)
    load_pointnet(m, params["params"])
    if split:  # two streams pooled separately, as the refine calls it
        parts = [(inp[:250], seg[:250], valid[:250]),
                 (inp[250:], seg[250:], valid[250:])]
        ref = jax.jit(lambda p, a: jm.apply(p, a, s, method="call_split"))(
            params, parts)
        with torch.no_grad():
            got = m.call_split([tuple(T(a) for a in part) for part in parts], s)
    else:
        ref = jax.jit(lambda p, a, b, c: jm.apply(p, a, b, s, c))(
            params, inp, seg, valid)
        with torch.no_grad():
            got = m(T(inp), T(seg), s, T(valid))
    assert got.shape == (s, 16)
    # 1e-5: f32 products of widths <= 32 summed in another order (the max
    # pools are exact)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


@pytest.mark.parametrize("kind", ["IEF", "IMNet"])
def test_decoder_modules_match(kind):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(64, 40)).astype(np.float32)
    jm = (JaxIEF if kind == "IEF" else JaxIMNet)(out_dim=1, gf_dim=8)
    params = randomize(jax.device_get(jax.jit(jm.init)(jax.random.key(0), x)),
                       rng)
    ref = jax.jit(jm.apply)(params, x)
    m = (IEF if kind == "IEF" else IMNet)(40, gf_dim=8)
    load_mlp_decoder(m, params["params"], kind)
    with torch.no_grad():
        got = m(T(x))
    # 1e-5: four f32 layers (inputs <= 56 wide) summed in another order
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


@pytest.mark.parametrize("kind", ["IEF", "IMNet"])
def test_randomized_decoder_outputs_lie_inside_the_clamp(kind):
    """randomize_weights_ gives outputs that a comparison can tell apart:
    spread over rows, and mostly inside (0, 1), where the soft clamp does
    not compress them."""
    m = (IEF if kind == "IEF" else IMNet)(40, gf_dim=64)
    before = m.mlp.l3.weight.clone()
    randomize_weights_(m, torch.Generator().manual_seed(0))
    assert not torch.equal(m.mlp.l3.weight, before)
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(512, 40)).astype(np.float32))
    with torch.no_grad():
        y = m(x)
    inside = ((y > 0) & (y < 1)).float().mean()
    assert 0.2 < y.mean() < 0.8 and y.std() > 0.03 and inside > 0.9, \
        (y.mean(), y.std(), inside)


def _tiny_models():
    cfg = load_config(overrides=tiny_overrides("float32"))
    static = build_static(cfg, n_rays=48 * 64)
    g = torch.Generator().manual_seed(0)
    return build_lidf(cfg, static, g), build_refine(cfg, static, g)


@pytest.mark.parametrize("model", ["lidf", "refine"])
@pytest.mark.parametrize("change", ["none", "in_place", "new_tensor", "dtype"])
def test_decode_operands_reused_until_the_weights_change(model, change):
    lidf, refine = _tiny_models()
    m = lidf if model == "lidf" else refine
    dec = m.offset_dec
    first = m.decode_operands()
    if change == "in_place":
        with torch.no_grad():
            dec.mlp.l1.weight.mul_(2.0)
    elif change == "new_tensor":
        dec.mlp.l1.weight.data = dec.mlp.l1.weight.data * 2.0
    elif change == "dtype":
        m.dtype = torch.bfloat16
    second = m.decode_operands()
    if change == "none":
        assert second is first
        return
    assert second is not first
    fresh = type(m).decode_operands(_fresh_like(m))
    for k, v in fresh.items():
        if torch.is_tensor(v):
            assert torch.equal(second[k], v), k
        else:
            assert second[k] == v, k


def _fresh_like(m):
    """A copy of ``m`` whose operand cache is empty."""
    c = copy.deepcopy(m)
    c._decode_w = PreparedWeights()
    return c
