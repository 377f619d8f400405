"""The training pair decode of the ``global`` and dense modes on the CPU:
the chunked recompute backward (``ops/pair_decode.py::
pair_decode_bwd_chunked``, which ``PairDecodeTrain`` runs after K6 on the
card) against one-shot autograd of ``pair_decode_plain``, and a stage-1
train step through ``PairDecodeTrain`` against the step's plain autograd.

On the CPU ``PairDecodeTrain``'s forward is the plain version (the wrapper
``pair_decode`` takes it for CPU tensors), so these tests hold everything
of the card's route but the kernel, which ``test_torch_port_cuda.py`` and
``chip_smoke.py`` hold against the plain version on the card.
"""

import copy

import numpy as np
import pytest
import torch

from implicit_depth_torch.builder import build_lidf, build_static
from implicit_depth_torch.config import load_config
from implicit_depth_torch.data.synthetic import synthetic_batch
from implicit_depth_torch.models import lidf as lidf_mod
from implicit_depth_torch.ops import decode_common as common
from implicit_depth_torch.ops import pair_decode as pd
from implicit_depth_torch.train.state import TrainState
from implicit_depth_torch.train.steps import make_lidf_train_step

torch.set_num_threads(2)
CV, C_ROI, C_DIR, MULTIRES, GF4 = 16, 32, 27, 8, 32
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _weights(rng):
    """Live decoder parameters (leaves) in the JAX layout."""
    c_embed = CV + C_ROI + 6 * (1 + 2 * MULTIRES) + C_DIR
    w = {"off_enc_w": rng.normal(size=(1, 16)),
         "off_enc_b": 0.1 * rng.normal(size=(16,))}
    for pre, in_dim in (("off_", c_embed + 16), ("prob_", c_embed)):
        dims = [(in_dim, GF4), (GF4, GF4 // 2), (GF4 // 2, GF4 // 4),
                (GF4 // 4, 1)]
        for i, (a, b) in enumerate(dims, 1):
            w[f"{pre}w{i}"] = rng.normal(size=(a, b)) / np.sqrt(a)
            w[f"{pre}b{i}"] = 0.1 * rng.normal(size=(b,))
        w[f"{pre}w4"] *= 0.25  # outputs inside (0, 1)
        w[f"{pre}b4"] = np.full((1,), 0.25 if pre == "off_" else 0.5)
    return {k: torch.tensor(v, dtype=torch.float32, requires_grad=True)
            for k, v in w.items()}


def _case(layout, dtype, seed=0, p=600, n_rays=50, n_table=30):
    """A pair decode's inputs: the ``global`` layout (rows indexing rays,
    a row count below the rows) or the dense one (P / N slots a ray)."""
    rng = np.random.default_rng(seed)
    g = torch.Generator().manual_seed(seed)
    return dict(
        w=_weights(rng),
        vox=torch.randn(n_table, CV, generator=g).requires_grad_(),
        cells=torch.randint(0, n_table, (p,), generator=g),
        pos=0.6 * torch.randn(p, 6, generator=g),
        ray_feat=torch.randn(n_rays, C_ROI + C_DIR, generator=g).to(
            dtype).requires_grad_(),
        rays=(None if layout == "dense"
              else torch.randint(0, n_rays, (p,), generator=g)),
        n_rows=(None if layout == "dense"
                else torch.tensor(451, dtype=torch.int32)),
        # every third row carries no gradient (as an empty slot)
        cot=tuple(torch.randn(p, generator=g)
                  * (torch.arange(p) % 3 != 1) for _ in range(2)))


def _rel_norm(got, ref):
    got, ref = got.double(), ref.double()
    return ((got - ref).norm() / ref.norm().clamp_min(1e-30)).item()


def _one_shot(c, dtype):
    """Autograd of pair_decode_plain in one piece: d vox, d ray_feat (the
    gather's sums taken in f32, then rounded to the ray rows' type, as the
    recompute sums them) and each parameter's gradient."""
    rf32 = c["ray_feat"].detach().float().requires_grad_()
    w32 = pd.pair_decode_weights(c["w"], CV, C_ROI, C_DIR, MULTIRES, dtype)
    out = pd.pair_decode_plain(c["vox"], c["cells"], c["pos"], rf32,
                               common.round_biases(w32, pd.FORMAT, dtype),
                               c["rays"], n_rows=c["n_rows"], dtype=dtype)
    grads = torch.autograd.grad(out, [c["vox"], rf32, *c["w"].values()],
                                c["cot"])
    return out, [grads[0], grads[1].to(dtype), *grads[2:]]


def _through_the_function(c, dtype):
    w32 = pd.pair_decode_weights(c["w"], CV, C_ROI, C_DIR, MULTIRES, dtype)
    out = pd.PairDecodeTrain.apply(
        (dtype, w32["dims"], 2, 0.001, False), c["vox"], c["cells"],
        c["pos"], c["ray_feat"], c["rays"], c["n_rows"],
        *(w32[k] for k in pd.FORMAT.operands))
    return out, list(torch.autograd.grad(
        out, [c["vox"], c["ray_feat"], *c["w"].values()], c["cot"]))


# chunks of 7 and 64 rows divide neither the 400 rows that carry a gradient
# nor the dense layout's 12 slots a ray; 1000 is one chunk
@pytest.mark.parametrize("chunk", [7, 64, 1000])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["global", "dense"])
def test_chunked_recompute_matches_one_shot_autograd(layout, dtype, chunk,
                                                     monkeypatch):
    """PairDecodeTrain's forward is the plain decode's bits; its gradients
    (the chunked recompute) are one-shot autograd's within f32 summation
    order: every gradient within 1e-5 of its norm (measured <= 2e-6), the
    bf16 ray rows within one bf16 rounding of their sums (2^-8; the
    one-shot gather summed in bf16 lies 4.6e-3 away). Rows at or past the
    row count and rows whose cotangents are 0 (every third) carry no
    gradient, and the recompute leaves them out."""
    monkeypatch.setattr(pd, "TRAIN_CHUNK_ROWS", chunk)
    tdt = DTYPES[dtype]
    c = _case(layout, tdt)
    ref_out, ref = _one_shot(c, tdt)
    got_out, got = _through_the_function(c, tdt)
    for g, r in zip(got_out, ref_out):
        assert torch.equal(g, r)
    if c["n_rows"] is not None:
        assert (ref_out[0][451:] == 0).all() and (ref_out[0][:451] != 0).all()
    names = ["vox", "ray_feat", *c["w"]]
    for name, g, r in zip(names, got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape, name
        tol = 2.0 ** -8 if (name == "ray_feat" and dtype == "bfloat16") \
            else 1e-5
        assert _rel_norm(g, r) <= tol, (name, _rel_norm(g, r))


@pytest.mark.parametrize("layout", ["global", "dense"])
def test_chunked_recompute_is_the_same_bits_run_to_run(layout, monkeypatch):
    monkeypatch.setattr(pd, "TRAIN_CHUNK_ROWS", 64)
    a = _through_the_function(_case(layout, torch.float32), torch.float32)[1]
    b = _through_the_function(_case(layout, torch.float32), torch.float32)[1]
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_rows_past_the_count_leave_the_gradients_alone(monkeypatch):
    """Cotangents at rows at or past the row count reach no gradient, and
    the recompute decodes only the rows below it whose cotangents are not
    0."""
    monkeypatch.setattr(pd, "TRAIN_CHUNK_ROWS", 64)
    c = _case("global", torch.float32)
    decoded, decode = [], pd.decode_rows

    def counting(vox_rows, *a):
        decoded.append(vox_rows.shape[0])
        return decode(vox_rows, *a)

    monkeypatch.setattr(pd, "decode_rows", counting)
    base = _through_the_function(c, torch.float32)[1]
    live = ((c["cot"][0] != 0) | (c["cot"][1] != 0))[:451].sum().item()
    assert decoded[0] == 600 and sum(decoded[1:]) == live < 451
    c2 = _case("global", torch.float32)
    c2["cot"] = tuple(torch.cat([t[:451], 100 * torch.randn(149)])
                      for t in c2["cot"])
    moved = _through_the_function(c2, torch.float32)[1]
    assert all(torch.equal(x, y) for x, y in zip(base, moved))


# -- a stage-1 step through the training Function ----------------------------

H, W = 48, 64


def _mode_cfg(tpu, dtype):
    return load_config(overrides={
        "mask_type": "all", "dataset": {"img_height": H, "img_width": W},
        "model": {"rgb_out": 8, "pnet_out": 16, "pnet_gf": 8, "imnet_gf": 8,
                  "resnet_stages": [1, 1, 1, 1]},
        "grid": {"res": 8, "miss_sample_num": 256, "valid_sample_num": 512},
        "tpu": {"max_pairs_per_ray": 12, "compute_dtype": dtype, **tpu}})


MODES = {"global": {"pairs_budget_mode": "global", "pairs_budget_per_ray": 2},
         "dense": {"pairs_budget_per_ray": 0}}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", list(MODES))
def test_train_step_through_the_recompute_is_plain_autograd(mode, dtype,
                                                            monkeypatch):
    """A stage-1 step whose pair decode takes PairDecodeTrain (the card's
    route, forward the plain version here) against the CPU step (plain
    autograd): the same losses bit for bit; every gradient of the decoders
    and the PointNet within 1e-5 of its norm (f32 summation order, measured
    <= 9e-7), plus 1e-7 for the probability decoder's last bias (a sum of
    cotangents that cancels to ~0). The ResNet's too in f32; in bf16 the
    recompute sums the ray rows' gradients in f32 where the plain gather's
    backward sums them in bf16, and the backward through the train-mode
    batch norms carries that into the ResNet's gradients (1.4e-2 at most
    here): 5e-2."""
    cfg = _mode_cfg(MODES[mode], dtype)
    gen = torch.Generator().manual_seed(3)
    model = build_lidf(cfg, build_static(cfg), gen)
    assert model.decode_mode == mode
    batch = {k: torch.from_numpy(v)
             for k, v in synthetic_batch(4, 2, H, W).items()}
    calls = []

    def through_function(vox, cells, pos, ray_feat, w32, rays=None, *,
                         dtype, **kw):
        calls.append(cells.shape[0])
        return pd.PairDecodeTrain.apply(
            (dtype, w32["dims"], kw["n_iter"], kw["init_offset"],
             kw["use_sigmoid"]), vox, cells, pos, ray_feat, rays,
            kw["n_rows"], *(w32[k] for k in pd.FORMAT.operands))

    runs = []
    for route in ("plain", "function"):
        m = copy.deepcopy(model)
        state = TrainState.create(m, cfg.training, steps_per_epoch=10)
        with monkeypatch.context() as mp:
            if route == "function":
                mp.setattr(lidf_mod, "pair_decode_train", through_function)
                mp.setattr(pd, "TRAIN_CHUNK_ROWS", 300)
            losses = make_lidf_train_step(cfg, m, "cpu")(
                state, batch, torch.Generator().manual_seed(0), 0)
        runs.append(({k: v.item() for k, v in losses.items()},
                     {n: p.grad for n, p in m.named_parameters()}))
    assert len(calls) == 1 and calls[0] > 3 * 300  # several chunks
    (lp, gp), (lf, gf) = runs
    assert lp == lf
    for n in gp:
        tol = 5e-2 if n.startswith("resnet.") and dtype == "bfloat16" \
            else 1e-5
        err = (gf[n] - gp[n]).double().norm().item()
        assert err <= tol * gp[n].double().norm().item() + 1e-7, (n, err)
