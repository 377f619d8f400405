"""The port's `global` and dense stage-1 decode modes and the save-free
decode backward against the JAX package, on the CPU.

K6's plain version against ``xla_pair_decode`` and the Pallas kernel in
interpret mode; the two modes through the whole serving slice, the eval step
and a train step (against ``jax.grad`` of the JAX ``loss_fn``), the JAX side
with ``use_pallas_decode`` off as it trains these modes; the plain gradient
of ``decode_bwd: kernel`` (``ray_decode_bwd_plain(saved=None)``) against the
JAX kernel backward in interpret mode. Every case feeds both frameworks the
same seeded numpy inputs and weights; the random draws are JAX's, passed in.
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
from implicit_depth_tpu.data.synthetic import synthetic_batch
from implicit_depth_tpu.models import lidf as jlidf
from implicit_depth_tpu.ops.pallas_decode import fused_pair_decode, xla_pair_decode
from implicit_depth_tpu.ops.pallas_ray_decode import (
    fused_ray_decode_table,
    pack_pair_pos,
)
from implicit_depth_tpu.train import state as jstate
from implicit_depth_tpu.train import steps as jsteps
from implicit_depth_torch.builder import build_lidf, build_refine, build_static
from implicit_depth_torch.config import load_config
from implicit_depth_torch.models.lidf import prepare_inputs
from implicit_depth_torch.ops import decode_common as common
from implicit_depth_torch.ops import pair_decode as pd
from implicit_depth_torch.ops import ray_decode as rd
from implicit_depth_torch.train.state import TrainState
from implicit_depth_torch.train.steps import (
    make_lidf_eval_step,
    make_lidf_train_step,
)
from implicit_depth_torch.weights import (
    lidf_from_jax,
    lidf_grads_from_jax,
    refine_from_jax,
)

torch.set_num_threads(2)
# a first torch.sin before any JAX computation (see test_torch_port_ops.py)
torch.sin(torch.zeros(1 << 16))
H, W = 48, 64
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
NO_EXCESS = {"xla_allow_excess_precision": False}


def T(a):
    return torch.from_numpy(np.array(a))


def N(t):
    return t.detach().float().numpy()


def assert_rel_max(got, ref, rtol, what="", atol=0.0):
    """max |got - ref| <= rtol · max |ref| + atol."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= rtol * scale + atol, \
        f"{what}: max error {err:.3g} of scale {scale:.3g}"


def assert_rel_norm(got, ref, rtol, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-12)
    assert err <= rtol, f"{what}: relative norm error {err:.3g}"


# -- K6: pair_decode_plain against the JAX decode ------------------------------

CV, C_ROI, C_DIR, MULTIRES, GF4 = 16, 32, 27, 8, 32


def _mlp(rng, w, pre, in_dim, bias_std):
    dims = [(in_dim, GF4), (GF4, GF4 // 2), (GF4 // 2, GF4 // 4), (GF4 // 4, 1)]
    for i, (a, b) in enumerate(dims, 1):
        w[f"{pre}w{i}"] = (rng.normal(size=(a, b)) / np.sqrt(a)).astype(np.float32)
        w[f"{pre}b{i}"] = (bias_std * rng.normal(size=(b,))).astype(np.float32)
    # outputs inside (0, 1), away from the soft clamp's kinks
    w[f"{pre}w4"] *= 0.25
    w[f"{pre}b4"] = np.full((1,), 0.25 if pre == "off_" else 0.5, np.float32)


def _decoder_weights(rng, prob_bias_std=0.1):
    """Decoder weights in the JAX layout. K6's cases draw the probability
    decoder's biases 1-3 at O(1), so that rounding them to bf16 (as K1's
    tail rounds its biases 2 and 3) moves the logits ~1e-3, far outside the
    bf16 tolerance below."""
    c_embed = CV + C_ROI + 6 * (1 + 2 * MULTIRES) + C_DIR
    w = {"off_enc_w": rng.normal(size=(1, 16)).astype(np.float32),
         "off_enc_b": (0.1 * rng.normal(size=(16,))).astype(np.float32)}
    _mlp(rng, w, "off_", c_embed + 16, 0.1)
    _mlp(rng, w, "prob_", c_embed, prob_bias_std)
    return w


def _pair_case(seed, p=100, n_rays=40, n_table=30):
    rng = np.random.default_rng(seed)
    return dict(w=_decoder_weights(rng, prob_bias_std=1.0),
                table=rng.normal(size=(n_table, CV)).astype(np.float32),
                cells=rng.integers(0, n_table, p).astype(np.int32),
                rays=rng.integers(0, n_rays, p).astype(np.int32),
                pos=(0.6 * rng.normal(size=(p, 6))).astype(np.float32),
                ray_feat=rng.normal(size=(n_rays, C_ROI + C_DIR)).astype(
                    np.float32))


def _jax_pair_decode(fn, c, jdt, **kw):
    """``fn`` (xla_pair_decode or fused_pair_decode) on the case's gathered
    rows, compiled without excess precision (XLA then rounds to bf16
    wherever the program says, as the port does)."""
    rf = c["ray_feat"][c["rays"]]
    args = (jnp.asarray(c["table"][c["cells"]], jdt),
            jnp.asarray(rf[:, :C_ROI], jdt), jnp.asarray(c["pos"][:, :3]),
            jnp.asarray(c["pos"][:, 3:]), jnp.asarray(rf[:, C_ROI:], jdt),
            {k: jnp.asarray(v) for k, v in c["w"].items()})
    f = jax.jit(lambda *a: fn(*a, multires=MULTIRES, dtype=jdt, **kw))
    out = f.lower(*args).compile(compiler_options=NO_EXCESS)(*args)
    return [np.asarray(o, np.float64) for o in out]


def _port_pair_decode(c, w, tdt, rays=True):
    got = pd.pair_decode(T(c["table"]).to(tdt), T(c["cells"]), T(c["pos"]),
                         T(c["ray_feat"]).to(tdt), w,
                         T(c["rays"]) if rays else None)
    assert all(g.shape == c["cells"].shape for g in got)
    return [N(g).astype(np.float64) for g in got]


# f32: one algebra in another summation order (measured ~2e-7); bf16: with
# excess precision off both sides round at the same places (measured 6e-8);
# 1e-4 leaves room for one bf16 rounding of a hidden activation moved by the
# summation order, and lies 10x below what K1's rounded biases move
PAIR_ATOL = {"float32": 1e-5, "bfloat16": 1e-4}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pair_decode_plain_matches_xla_and_the_pallas_kernel(dtype):
    c = _pair_case(40)  # P = 100: a ragged last tile of 64 rows
    tdt, jdt = DTYPES[dtype]
    w = pd.prep_pair_decode_weights({k: T(v) for k, v in c["w"].items()}, CV,
                                    C_ROI, C_DIR, MULTIRES, tdt)
    got = _port_pair_decode(c, w, tdt)
    for name, ref in (
            ("xla_pair_decode", _jax_pair_decode(xla_pair_decode, c, jdt)),
            ("fused_pair_decode", _jax_pair_decode(
                fused_pair_decode, c, jdt, tile=64, interpret=True))):
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g, r, atol=PAIR_ATOL[dtype], rtol=0,
                                       err_msg=name)
    if dtype == "bfloat16":
        # K1's tail rounds the probability decoder's biases 2 and 3: K6
        # must not, and the tolerance above tells the two apart
        mutant = {**w, **{k: common.rounded(w[k], tdt)
                          for k in ("prob_b2", "prob_b3")}}
        off_m, logit_m = _port_pair_decode(c, mutant, tdt)
        assert np.abs(logit_m - ref[1]).max() > 10 * PAIR_ATOL[dtype]


def test_pair_decode_dense_layout_is_the_indexed_one():
    """rays=None reads ray row // (P / N): the same bits as those indices."""
    c = _pair_case(41, p=120, n_rays=40)
    c["rays"] = (np.arange(120) // 3).astype(np.int32)
    w = pd.prep_pair_decode_weights({k: T(v) for k, v in c["w"].items()}, CV,
                                    C_ROI, C_DIR, MULTIRES, torch.bfloat16)
    for a, b in zip(_port_pair_decode(c, w, torch.bfloat16),
                    _port_pair_decode(c, w, torch.bfloat16, rays=False)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        pd.pair_decode_plain(T(c["table"]), T(c["cells"][:119]),
                             T(c["pos"][:119]), T(c["ray_feat"]), w)


# -- K6's layer-1 layout and the row count ------------------------------------

def _pe_col(u, multires):
    """(element of pos6, kind 0 x / 1 sin / 2 cos, scale) of column u of a
    pair's [pe(enter) | pe(leave)] block, or None past it: a transcription of
    csrc/pair_decode.cu's pe_col, by which each lane stages its columns."""
    c_pe = 3 * (1 + 2 * multires)
    if u >= 2 * c_pe:
        return None
    which, t = divmod(u, c_pe)
    if t < 3:
        return which * 3 + t, 0, 1.0
    v = t - 3
    return which * 3 + v % 3, 1 + (v % 6) // 3, float(2 ** (v // 6))


def _kernel_x(c, lay):
    """X as pair_decode_tc stages it (f32, unrounded): the voxel row and the
    zero-padded ray row gathered by index into columns [0, o_pe), then each
    column of [pe(enter) | pe(leave) | 0] from its lane's column table."""
    rows = torch.cat([T(c["table"])[T(c["cells"]).long()],
                      common.pad_columns(T(c["ray_feat"]), lay["c_rp"])[
                          T(c["rays"]).long()]], 1)
    pos = T(c["pos"]).double()
    cols = []
    for u in range(lay["kp"] - lay["o_pe"]):
        col = _pe_col(u, MULTIRES)
        if col is None:
            cols.append(torch.zeros(pos.shape[0], dtype=torch.float64))
            continue
        src, kind, scale = col
        x = pos[:, src]
        cols.append(x if kind == 0 else
                    (torch.sin if kind == 1 else torch.cos)(x * scale))
    return torch.cat([rows.double(), torch.stack(cols, 1)], 1)


def test_kernel_layer1_layout_gives_the_embedding_order_layer1():
    """The kernel's layer-1 operands (w1's rows reordered and zero-padded,
    the ray rows padded to c_rp, the positional encoding staged by lane
    column tables), emulated here, give the layer-1 pre-activation of the
    JAX package's embedding order [vox | roi | pe(enter) | pe(leave) |
    dir_e] @ w1, and so does the plain version's layer1. f32 sums in
    another order: within 1e-5 of the largest value (measured ~1e-7); a
    shifted block of rows or columns is off by O(1)."""
    c = _pair_case(43)
    lay = pd.pair_layout(CV, C_ROI, C_DIR, MULTIRES)
    assert lay["c_rp"] % 8 == 0 and lay["kp"] % 16 == 0
    wj = {k: T(v) for k, v in c["w"].items()}
    w = pd.prep_pair_decode_weights(wj, CV, C_ROI, C_DIR, MULTIRES,
                                    torch.float32)
    assert w["w1"].shape == (lay["kp"], 2 * GF4)
    # the embedding order of _decode_tile, and its layer-1 weights
    rf = T(c["ray_feat"])[T(c["rays"]).long()]
    pos = T(c["pos"])
    emb = torch.cat([T(c["table"])[T(c["cells"]).long()], rf[:, :C_ROI],
                     pd.posenc_rows(pos[:, :3], MULTIRES),
                     pd.posenc_rows(pos[:, 3:], MULTIRES), rf[:, C_ROI:]], 1)
    w1_emb = torch.cat([wj["off_w1"][:emb.shape[1]], wj["prob_w1"]], 1)
    ref = (emb.double() @ w1_emb.double()).numpy()
    emu = (_kernel_x(c, lay) @ w["w1"].double()).numpy()
    plain = (pd.layer1(T(c["table"]), T(c["cells"]), pos, T(c["ray_feat"]), w,
                       T(c["rays"]), torch.float32) - w["b1"]).numpy()
    scale = np.abs(ref).max()
    np.testing.assert_allclose(emu, ref, atol=1e-5 * scale, rtol=0)
    np.testing.assert_allclose(plain, ref, atol=1e-5 * scale, rtol=0)
    # the padding rows of w1 are zero: X's padding columns add nothing
    pad = torch.ones(lay["kp"], dtype=torch.bool)
    pad[:CV + C_ROI + C_DIR] = False
    pad[lay["o_pe"]:lay["o_pe"] + 2 * lay["c_pe"]] = False
    assert (w["w1"][pad] == 0).all() and pad.sum() > 0
    # a mutant that swaps the two positions' blocks is far off
    swapped = w["w1"].clone()
    o, k = lay["o_pe"], lay["c_pe"]
    swapped[o:o + k], swapped[o + k:o + 2 * k] = \
        w["w1"][o + k:o + 2 * k], w["w1"][o:o + k]
    bad = (_kernel_x(c, lay) @ swapped.double()).numpy()
    assert np.abs(bad - ref).max() > 100 * 1e-5 * scale


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("indexed", [True, False])
def test_pair_decode_plain_zeroes_rows_at_or_past_the_count(dtype, indexed):
    """n_rows = 0, 1, 63, 64, 65, P (and past P): rows >= n_rows exactly 0
    in both outputs, the rows below it the bits of the call without a
    count."""
    c = _pair_case(44, p=120, n_rays=40)
    tdt = DTYPES[dtype][0]
    w = pd.prep_pair_decode_weights({k: T(v) for k, v in c["w"].items()}, CV,
                                    C_ROI, C_DIR, MULTIRES, tdt)
    args = (T(c["table"]).to(tdt), T(c["cells"]), T(c["pos"]),
            T(c["ray_feat"]).to(tdt), w, T(c["rays"]) if indexed else None)
    full = pd.pair_decode(*args)
    assert all((f != 0).all() for f in full)
    for n in (0, 1, 63, 64, 65, 120, 130):
        got = pd.pair_decode(*args, n_rows=torch.tensor(n, dtype=torch.int32))
        k = min(n, 120)
        for g, f in zip(got, full):
            assert g.shape == (120,) and (g[k:] == 0).all()
            assert torch.equal(g[:k], f[:k])


# -- the two modes through the serving slice -----------------------------------

def tiny_overrides(dtype, tpu):
    """The tiny model of test_torch_port_slice.py in another decode mode."""
    return {
        "mask_type": "all",
        "dataset": {"img_height": H, "img_width": W},
        "model": {"rgb_out": 8, "pnet_out": 16, "pnet_gf": 8, "imnet_gf": 8,
                  "resnet_stages": [1, 1, 1, 1]},
        "refine": {"pnet_out": 16, "pnet_gf": 8, "imnet_gf": 8},
        "grid": {"res": 8, "miss_sample_num": 256, "valid_sample_num": 512},
        "tpu": {"max_pairs_per_ray": 12, "use_pallas_decode": False,
                "compute_dtype": dtype, **tpu},
    }


DENSE = {"pairs_budget_per_ray": 0}


def GLOBAL(budget):
    return {"pairs_budget_mode": "global", "pairs_budget_per_ray": budget}


def randomize(tree, rng):
    """Every leaf redrawn at O(1) activation scale (as in
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


def run_slice(dtype, tpu, refine=True):
    """Both frameworks on one batch -> (jax outputs, port outputs) as numpy,
    the port's model in the mode ``tpu`` selects."""
    overrides = tiny_overrides(dtype, tpu)
    jcfg = jax_load_config(overrides=overrides)
    jstatic = jax_build_static(jcfg, n_rays=H * W)
    jlidf_m = jax_build_lidf(jcfg, jstatic)
    raw = synthetic_batch(3, 1, H, W)
    batch = {k: jnp.asarray(v) for k, v in raw.items()}
    jin = jax.jit(lambda b, k: jlidf.prepare_inputs(
        jstatic, b, k, train=False, mask_type="all"))(batch, jax.random.key(0))
    lvars = jax.jit(lambda k, i: jlidf_m.init(k, i, train=False,
                                              use_gt_label=False))(
        jax.random.key(1), jin)
    rng = np.random.default_rng(7)
    lvars = randomize(jax.device_get(lvars), rng)
    lout = jax.jit(lambda v, i: jlidf_m.apply(v, i, train=False,
                                              use_gt_label=False))(lvars, jin)
    cfg = load_config(overrides=overrides)
    static = build_static(cfg, n_rays=H * W)
    lidf = lidf_from_jax(lvars, build_lidf(cfg, static)).eval()
    tb = {k: torch.from_numpy(np.array(v)) for k, v in raw.items()}
    with torch.no_grad():
        inp = prepare_inputs(static, tb, valid_idx=T(jin["valid_idx"]))
        out = lidf(inp)
    # the outputs' pair_valid is the inputs' & decoded in the global mode
    jax_np = {**jin, "pair_valid_in": jin["pair_valid"], **lout}
    port_np = {**inp, "pair_valid_in": inp["pair_valid"], **out}
    if refine:
        jref = jax_build_refine(jcfg, jstatic)
        rvars = jax.jit(lambda k, i, o: jref.init(k, i, o, o["pred_pos"]))(
            jax.random.key(2), jin, lout)
        rparams = randomize(jax.device_get(rvars["params"]), rng)

        @jax.jit
        def refine2(p, i, o):
            pred = o["pred_pos"]
            for _ in range(2):
                pred = jref.apply({"params": p}, i, o, pred)
            return pred

        jax_np["refined"] = refine2(rparams, jin, lout)
        ref = refine_from_jax(rparams, build_refine(cfg, static)).eval()
        with torch.no_grad():
            pred = out["pred_pos"]
            for _ in range(2):
                pred = ref(inp, out, pred)
        port_np["refined"] = pred
    assert lidf.decode_mode == ("dense" if tpu is DENSE else "global")
    return ({k: np.asarray(v, np.float32) for k, v in jax_np.items()
             if k not in ("prob_softmax", "pair_pred_pos")},
            {k: v.float().numpy() for k, v in port_np.items()})


@pytest.mark.parametrize("budget", [1, 12])  # overflowing; >= K (all kept)
def test_global_selection_matches_jax(budget):
    """decoded (the outputs' pair_valid is the inputs' & decoded), max_slot
    and has_pair equal JAX's; the logits of the decoded pairs and the
    positions within f32 summation order (1e-4, as test_slice_f32)."""
    j, p = run_slice("float32", GLOBAL(budget), refine=False)
    for key in ("pair_valid_in", "pair_valid", "max_slot", "has_pair"):
        np.testing.assert_array_equal(p[key], j[key], err_msg=key)
    n_valid, n_decoded = p["pair_valid_in"].sum(), p["pair_valid"].sum()
    if budget == 1:   # B·R rows: the farthest pairs are dropped
        assert n_decoded == H * W < n_valid
        # k-major: every ray with a pair keeps its nearest one
        np.testing.assert_array_equal(p["pair_valid"][..., 0],
                                      p["pair_valid_in"][..., 0])
        assert (j["max_slot"] == 0).all()  # no other slot was decoded
    else:
        assert n_decoded == n_valid
        assert j["max_slot"].std() > 0  # the slots really compete
    np.testing.assert_allclose(p["prob_logit"], j["prob_logit"], atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(p["pred_pos"], j["pred_pos"], atol=1e-4, rtol=0)


@pytest.fixture(scope="module", params=["dense", "global"])
def mode(request):
    return request.param


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slice_in_mode(mode, dtype):
    """The two-stage slice in the dense mode and in the global mode (budget
    2, which overflows here), outputs (B, R, K), held as test_slice_f32 and
    test_slice_bf16 of test_torch_port_slice.py hold the per_ray mode."""
    j, p = run_slice(dtype, DENSE if mode == "dense" else GLOBAL(2))
    assert p["prob_logit"].shape == (1, H * W, 12)
    for key in ("pair_valid", "has_pair"):
        np.testing.assert_array_equal(p[key], j[key], err_msg=key)
    if dtype == "float32":
        assert j["max_slot"].std() > 0
        np.testing.assert_array_equal(p["max_slot"], j["max_slot"])
        # the same f32 algebra summed in another order
        for key in ("prob_logit", "pred_pos", "refined"):
            np.testing.assert_allclose(p[key], j[key], atol=1e-4, rtol=0,
                                       err_msg=key)
    else:
        # bf16 rounds at other places in the two frameworks (ResNet,
        # PointNet, the refine): a near-tie can pick another slot; logits
        # and positions within a few bf16 ulps (as test_slice_bf16)
        same = p["max_slot"] == j["max_slot"]
        assert same.mean() >= 0.99, same.mean()
        np.testing.assert_allclose(p["prob_logit"], j["prob_logit"],
                                   atol=0.05, rtol=0)
        for key in ("pred_pos", "refined"):
            np.testing.assert_allclose(p[key][same], j[key][same], atol=0.02,
                                       rtol=0, err_msg=key)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("budget", [2, 12])  # dropped pairs; pad rows
def test_global_mode_count_leaves_decode_rays_unchanged(dtype, budget,
                                                        monkeypatch):
    """The port's global mode decoding only the valid prefix (the device
    count it passes) gives decode_rays' outputs bit for bit as decoding
    every row, pad rows included, as the JAX package does."""
    from implicit_depth_torch.builder import randomize_weights_
    from implicit_depth_torch.data.synthetic import synthetic_batch as tsb
    from implicit_depth_torch.models import lidf as lidf_mod

    cfg = load_config(overrides=tiny_overrides(dtype, GLOBAL(budget)))
    static = build_static(cfg, n_rays=H * W)
    g = torch.Generator().manual_seed(5)
    model = randomize_weights_(build_lidf(cfg, static, g), g).eval()
    batch = {k: torch.from_numpy(v) for k, v in tsb(4, 1, H, W).items()}
    with torch.no_grad():
        inp = prepare_inputs(static, batch,
                             generator=torch.Generator().manual_seed(0))
        counts = []
        original = lidf_mod.pair_decode

        def recorder(*a, n_rows=None, **kw):
            counts.append(int(n_rows))
            return original(*a, n_rows=n_rows, **kw)

        monkeypatch.setattr(lidf_mod, "pair_decode", recorder)
        with_count = model(inp)
        monkeypatch.setattr(lidf_mod, "pair_decode",
                            lambda *a, n_rows=None, **kw: original(*a, **kw))
        without = model(inp)
    p = min(H * W * budget, H * W * 12)
    n_valid = int(inp["pair_valid"].sum())
    assert counts == [min(n_valid, p)]
    assert counts[0] < p if budget == 12 else counts[0] == p
    for k, v in with_count.items():
        assert torch.equal(v, without[k]), k


# -- the eval and train steps in the global mode -------------------------------

def _both_models(dtype, tpu, seed):
    """The JAX and port stage-1 models with the same randomized weights, and
    a training batch (as _both_models of test_torch_port_train.py)."""
    overrides = {**tiny_overrides(dtype, tpu), "refine": {}}
    jcfg = jax_load_config(overrides=overrides)
    jstatic = jax_build_static(jcfg)
    jmodel = jax_build_lidf(jcfg, jstatic)
    raw = synthetic_batch(seed, 2, H, W)
    jin = jax.jit(lambda b, k: jlidf.prepare_inputs(jstatic, b, k, train=True))(
        {k: jnp.asarray(v) for k, v in raw.items()}, jax.random.key(seed))
    var = jax.jit(lambda k, i: jmodel.init(k, i, train=False,
                                           use_gt_label=False))(
        jax.random.key(1), jin)
    var = randomize(jax.device_get(var), np.random.default_rng(seed))
    # decoder outputs inside (0, 1), away from the soft clamp's kinks
    for dec, bias in (("offset_dec", 0.5 / jcfg.model.n_iter),
                      ("prob_dec", 0.5)):
        last = var["params"][dec]["_MLP4_0"]["Dense_3"]
        last["kernel"] = last["kernel"] * 0.25
        last["bias"] = np.full_like(last["bias"], bias)
    cfg = load_config(overrides=overrides)
    model = lidf_from_jax(var, build_lidf(cfg, build_static(cfg)))
    return jcfg, jstatic, jmodel, var, raw, cfg, model


def test_eval_step_in_global_mode_matches_jax():
    jcfg, jstatic, jmodel, var, raw, cfg, model = _both_models(
        "float32", GLOBAL(2), 36)
    tx = jstate.make_optimizer("adam", 1e-3)
    jstate_ = jstate.TrainState.create(var["params"], var["batch_stats"], tx)
    jin, jout, jl = jsteps.make_lidf_eval_step(jcfg, jmodel)(
        jstate_, {k: jnp.asarray(v) for k, v in raw.items()},
        jax.random.key(3))
    state = TrainState.create(model, cfg.training, steps_per_epoch=10)
    inp, out, losses = make_lidf_eval_step(cfg, model, "cpu")(
        state, {k: T(v) for k, v in raw.items()},
        valid_idx=T(jin["valid_idx"]))
    assert model.decode_mode == "global" and not model.training
    assert out["prob_logit"].shape[-1] == 12
    for k in jl:  # f32 through the whole model, in another order
        np.testing.assert_allclose(N(losses[k]), np.asarray(jl[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    for key in ("pair_valid", "max_slot"):
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(jout[key]))
    np.testing.assert_allclose(N(out["pred_pos"]), np.asarray(jout["pred_pos"]),
                               atol=1e-4, rtol=0)


TRAIN_MODES = {"global": GLOBAL(2), "dense": DENSE}
# bf16: each group's (largest, median) relative norm error of a parameter's
# gradient against jax.grad (XLA without excess precision), as
# test_torch_port_train.py's BF16_GRAD_LIMITS for the per_ray mode: the two
# frameworks round the same program at the same places but sum the
# convolutions, products and the gathers' backward in other orders, and
# the backward through the train-mode batch norms amplifies the flips.
# Readings here, the same in both modes (the dense mode's extra slots carry
# zero cotangents, and the global budget keeps every valid pair of this
# training batch): resnet 0.151 (median 0.120), pnet 0.055 (0.035),
# offset_dec 0.037 (0.013), prob_dec 0.074 (0.034); limits about 1.5x
BF16_MODE_GRAD_LIMITS = {"resnet": (0.25, 0.17), "pnet": (0.09, 0.05),
                         "offset_dec": (0.06, 0.02), "prob_dec": (0.12, 0.05)}


def _mode_step(mode, dtype, seed):
    """One train step of both frameworks in ``mode`` -> (port model after
    its step, its losses, JAX's losses, JAX's gradients in the port's
    names)."""
    jcfg, jstatic, jmodel, var, raw, cfg, model = _both_models(
        dtype, TRAIN_MODES[mode], seed)
    batch = {k: jnp.asarray(v) for k, v in raw.items()}
    epoch = 0  # the curriculum's labelled slot, among the decoded pairs

    def jstep(params, stats, b, key, ep):
        inputs = jlidf.prepare_inputs(jstatic, b, key, train=True)

        def loss_fn(p):
            o, _ = jmodel.apply({"params": p, "batch_stats": stats}, inputs,
                                train=True,
                                use_gt_label=ep < jcfg.model.maxpool_label_epo,
                                mutable=["batch_stats"])
            # a traced epoch, as the JAX train step passes it (the smooth
            # term's gate then defers to its weight)
            kw = jsteps._loss_kwargs(jcfg, True, ep)
            kw["prob_w"] = jcfg.loss.prob_w
            losses = jlidf.lidf_loss(inputs, o, **kw)
            return losses["loss_net"], losses

        grads, losses = jax.grad(loss_fn, has_aux=True)(params)
        return inputs, grads, losses

    args = (var["params"], var["batch_stats"], batch, jax.random.key(2),
            jnp.asarray(epoch))
    compiled = jax.jit(jstep).lower(*args).compile(
        compiler_options=None if dtype == "float32" else NO_EXCESS)
    jin, jgrads, jlosses = compiled(*args)
    state = TrainState.create(model, cfg.training, steps_per_epoch=10)
    losses = make_lidf_train_step(cfg, model, "cpu")(
        state, {k: T(v) for k, v in raw.items()}, None, epoch,
        valid_idx=T(jin["valid_idx"]), miss_start=T(jin["miss_start"]))
    assert model.decode_mode == mode
    return (model, losses, jlosses,
            lidf_grads_from_jax(jax.device_get(jgrads), model))


@pytest.mark.parametrize("mode", list(TRAIN_MODES))
def test_train_step_in_mode_matches_jax_grad(mode):
    """One f32 step on the CPU (the decode's plain version under autograd,
    the same algebra as the card's recompute backward) in the ``global``
    mode (budget 2, pairs dropped) and the dense mode (K 12 > kb) against
    jax.grad of the JAX loss_fn (xla_pair_decode under autograd): every
    loss and parameter gradient within 1e-4 of its scale (plus 1e-7 for
    sums that cancel), as test_train_step_matches_jax_grad."""
    model, losses, jlosses, want = _mode_step(mode, "float32", 37)
    for k in jlosses:
        np.testing.assert_allclose(N(losses[k]), np.asarray(jlosses[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    for name, p in model.named_parameters():
        assert_rel_max(N(p.grad), N(want[name]), 1e-4, name, atol=1e-7)


@pytest.mark.parametrize("mode", list(TRAIN_MODES))
def test_bf16_train_step_in_mode_matches_jax_grad_per_group(mode):
    """The bf16 step of each mode against jax.grad compiled without excess
    precision: the losses within a few bf16 ulps of each term (2e-2, as
    the per_ray bf16 step), each parameter's gradient by the relative norm
    of its error, held per group to BF16_MODE_GRAD_LIMITS."""
    model, losses, jlosses, want = _mode_step(mode, "bfloat16", 37)
    for k in jlosses:
        np.testing.assert_allclose(N(losses[k]), np.asarray(jlosses[k]),
                                   rtol=2e-2, atol=1e-3, err_msg=k)
    errs = {}
    for name, p in model.named_parameters():
        diff = np.linalg.norm(N(p.grad) - N(want[name]))
        # a sum that cancels to ~1e-9 (the probability decoder's last
        # bias) is held to 1e-7, as in test_train_step_matches_jax_grad
        errs[name] = (0.0 if diff <= 1e-7
                      else diff / np.linalg.norm(N(want[name])))
    assert {n.split(".")[0] for n in errs} == set(BF16_MODE_GRAD_LIMITS)
    for group, (largest, median) in BF16_MODE_GRAD_LIMITS.items():
        e = {n: v for n, v in errs.items() if n.split(".")[0] == group}
        worst, med = max(e, key=e.get), np.median(list(e.values()))
        assert e[worst] <= largest and med <= median, \
            f"{group}: largest {e[worst]:.3g} ({worst}), median {med:.3g}"


# -- decode_bwd 'kernel': the save-free backward ------------------------------

KB, N_IMG, RAYS_PER_IMG, CELLS, TILE = 8, 2, 32, 40, 16


def _ray_case(seed):
    rng = np.random.default_rng(seed)
    n = N_IMG * RAYS_PER_IMG
    local = rng.integers(0, CELLS, (n, KB)).astype(np.int32)
    img = np.arange(n)[:, None] // RAYS_PER_IMG
    return dict(
        w=_decoder_weights(rng), local=local,
        cells=(local + img * CELLS).astype(np.int32),
        table=rng.normal(size=(N_IMG * CELLS, CV)).astype(np.float32),
        pos=(0.6 * rng.normal(size=(n, KB, 6))).astype(np.float32),
        ray_feat=rng.normal(size=(n, C_ROI + C_DIR)).astype(np.float32),
        g_off=rng.normal(size=(n, KB)).astype(np.float32),
        g_logit=rng.normal(size=(n, KB)).astype(np.float32))


@pytest.mark.parametrize("dtype,use_sigmoid", [
    ("float32", False), ("float32", True), ("bfloat16", False)])
def test_ray_decode_bwd_plain_unsaved_matches_jax_kernel_bwd(dtype, use_sigmoid):
    """ray_decode_bwd_plain(saved=None), K3's recompute variant's plain
    version, against jax.vjp of fused_ray_decode_table(bwd_impl='kernel')
    (the Pallas backward that recomputes layer 1) in interpret mode. The
    port's gradients at the split operands are laid back onto the JAX
    weight layout through split_ray_decode_weights' own autograd."""
    c = _ray_case(42)
    tdt, jdt = DTYPES[dtype]
    jargs = (jnp.asarray(c["local"]),
             pack_pair_pos(jnp.asarray(c["pos"][..., :3]),
                           jnp.asarray(c["pos"][..., 3:])),
             jnp.asarray(c["ray_feat"], jdt), jnp.asarray(c["table"], jdt))

    def jfwd(rf, tb, ws):
        return fused_ray_decode_table(
            jargs[0], jargs[1], rf, tb, ws, KB, RAYS_PER_IMG // TILE,
            MULTIRES, 2, 0.001, use_sigmoid, jdt, TILE, True, "kernel")

    jw = {k: jnp.asarray(v) for k, v in c["w"].items()}
    _, vjp = jax.vjp(jfwd, jargs[2], jargs[3], jw)
    jd_rf, jd_tab, jd_w = vjp((jnp.asarray(c["g_off"]),
                               jnp.asarray(c["g_logit"])))

    w = {k: T(v).requires_grad_() for k, v in c["w"].items()}
    w32 = rd.split_ray_decode_weights(w, CV, C_ROI, C_DIR, MULTIRES, tdt)
    d_tab, d_rf, d_ops = rd.ray_decode_bwd_plain(
        T(c["table"]).to(tdt), T(c["cells"]), T(c["pos"]),
        T(c["ray_feat"]).to(tdt), w32, T(c["g_off"]), T(c["g_logit"]),
        use_sigmoid=use_sigmoid, dtype=tdt, saved=None)
    d_w = torch.autograd.grad([w32[k] for k in rd.FORMAT.operands],
                              list(w.values()),
                              [d_ops[k] for k in rd.FORMAT.operands])
    got = {"d_table": N(d_tab), "d_ray_feat": N(d_rf),
           **{k: N(g) for k, g in zip(w, d_w)}}
    want = {"d_table": jd_tab, "d_ray_feat": jd_rf, **jd_w}
    for k, g in got.items():
        ref = np.asarray(want[k], np.float32)
        if dtype == "float32":  # one algebra, another order
            assert_rel_max(g, ref, 1e-4, k, atol=1e-7)
        else:  # the JAX kernel rounds each cotangent to bf16 before its
            # product, plain autograd with straight-through casts does not
            assert_rel_norm(g, ref, 2e-2, k)
