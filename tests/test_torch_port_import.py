"""The port's reader of the reference's ``.pth`` checkpoints
(``implicit_depth_torch/utils/torch_import.py`` and
``tools/import_torch_ckpt.py``) against the JAX package's converter, on the
CPU.

No reference file exists here, so each case builds the reference's state
dicts by name and shape from a seeded generator (as
``tests/test_torch_import.py::_fake_pnet_sd`` does for the PointNet), for
both stages, with an IEF and with an IMNet offset decoder. The JAX side is
``convert_lidf_checkpoint`` / ``convert_refine_checkpoint`` (numpy only)
followed by ``weights.lidf_from_jax`` / ``refine_from_jax``.
"""

import math

import jax
import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_port_disk import (  # noqa: F401 (weights: a fixture)
    H,
    W,
    _frame,
    _port_pair,
    serve_overrides,
    weights,
)

from implicit_depth_tpu.config import load_config as jax_load_config
from implicit_depth_tpu.infer import DepthCompleter as JaxDepthCompleter
from implicit_depth_tpu.train.feed import (
    fuse_bytes,
    pack_batch,
    unpack_for_spec,
)
from implicit_depth_tpu.utils.torch_import import (
    convert_lidf_checkpoint,
    convert_refine_checkpoint,
)
from implicit_depth_torch import main as port_main
from implicit_depth_torch.builder import build_lidf, build_refine, build_static
from implicit_depth_torch.config import load_config
from implicit_depth_torch.infer import DepthCompleter
from implicit_depth_torch.models.resnet import ResNet34_8s
from implicit_depth_torch.tools import complete_depth as port_complete
from implicit_depth_torch.tools import import_torch_ckpt
from implicit_depth_torch.train.checkpoint import Checkpointer
from implicit_depth_torch.utils import torch_import as ti
from implicit_depth_torch.weights import lidf_from_jax, refine_from_jax

torch.set_num_threads(2)
# a first torch.sin before any JAX computation (see test_torch_port_ops.py)
torch.sin(torch.zeros(1 << 16))

# the serving tests' widths (test_torch_port_disk.serve_overrides)
RGB, PNET, PNET_GF, GF, STAGES = 8, 16, 8, 8, (1, 1, 1, 1)
EMBED1 = PNET + RGB * 4 + 2 * 51 + 27          # stage 1, posenc on
EMBED2 = PNET + RGB * 4 + 51 + 27              # stage 2


def _normal(g, shape, std, mean=0.0):
    return torch.randn(shape, generator=g) * std + mean


def ref_resnet(g, out_ch=RGB, stages=STAGES):
    """``Resnet34_8s``'s state dict by name and shape (keys
    ``resnet34_8s.*``, blocks ``layer{s}.{i}``, shortcut ``downsample.0/1``,
    ``num_batches_tracked``), weights at unit activation scale."""
    sd = {}
    for k, v in ResNet34_8s(out_ch=out_ch, stage_sizes=stages).state_dict(
            ).items():
        name = k
        for s in range(1, 5):
            for i in range(max(stages)):
                name = name.replace(f"layer{s}_{i}.", f"layer{s}.{i}.")
        name = name.replace("down_conv.", "downsample.0.").replace(
            "down_bn.", "downsample.1.")
        if k.endswith("num_batches_tracked"):
            t = torch.tensor(7)
        elif k.endswith("running_var"):
            t = 0.5 + 0.5 * _normal(g, v.shape, 1.0).abs()
        elif k.endswith(".weight") and "bn" in k.split(".")[-2]:
            t = _normal(g, v.shape, 0.1, 1.0)
        elif v.dim() == 4:
            t = _normal(g, v.shape, 1.0 / math.sqrt(v[0].numel()))
            if k == "fc.weight":
                t = t * 0.25
        else:
            t = _normal(g, v.shape, 0.1)
        sd["resnet34_8s." + name] = t
    return sd


def ref_pointnet(g, out=PNET, gf=PNET_GF):
    dims = {"point_lin1": (gf, 6), "point_lin2": (out // 2, gf),
            "vox_lin1": (out // 2, out // 2), "point_lin3": (out, out),
            "point_lin4": (out, out), "vox_lin2": (out, out)}
    sd = {}
    for name, (o, i) in dims.items():
        sd[name + ".weight"] = _normal(g, (o, i), 1.0 / math.sqrt(i))
        sd[name + ".bias"] = _normal(g, (o,), 0.1)
    return sd


def ref_decoder(g, inp, ief, gf=GF, n_iter=2):
    """``IEF`` (``offset_enc`` 1 -> 16 and ``linear_1..4``, layer 1 taking
    the embedding and then the encoded offset) or ``IMNet``; the raw output
    near 0.5, inside the soft clamp."""
    sd = {}
    if ief:
        sd["offset_enc.weight"] = _normal(g, (16, 1), 1.0)
        sd["offset_enc.bias"] = _normal(g, (16,), 0.1)
    dims = [inp + 16 * ief, 4 * gf, 2 * gf, gf, 1]
    for i in range(4):
        sd[f"linear_{i + 1}.weight"] = _normal(
            g, (dims[i + 1], dims[i]), (0.25 if i == 3 else 1.0)
            / math.sqrt(dims[i]))
        sd[f"linear_{i + 1}.bias"] = (
            torch.full((1,), 0.5 / (n_iter if ief else 1)) if i == 3
            else _normal(g, (dims[i + 1],), 0.1))
    return sd


def ref_stage1(seed, ief=True, embed=EMBED1):
    g = torch.Generator().manual_seed(seed)
    return {"resnet_model": ref_resnet(g), "pnet_model": ref_pointnet(g),
            "offset_dec": ref_decoder(g, embed, ief),
            "prob_dec": ref_decoder(g, embed, False),
            "optimizer": {"state": {}, "param_groups": [{"lr": 1e-3}]},
            "epoch": 59, "xyz_err": np.float64(0.05), "acc": 0.5}


def ref_stage2(seed, ief=True, embed=EMBED2):
    g = torch.Generator().manual_seed(seed)
    return {"pnet_model_refine": ref_pointnet(g),
            "offset_dec_refine": ref_decoder(g, embed, ief),
            "optimizer": {}, "epoch": 29, "xyz_err": np.float32(0.04)}


def _np(sd):
    return {k: (v if not torch.is_tensor(v) else v.numpy())
            for k, v in sd.items()}


def _np_ckpt(ckpt):
    return {k: _np(v) if isinstance(v, dict) else v for k, v in ckpt.items()}


def port_cfg(offdec="IEF", pos_encode=True):
    o = serve_overrides()
    o["model"].update(offdec_type=offdec, pos_encode=pos_encode)
    o["refine"].update(offdec_type=offdec, pos_encode=pos_encode)
    return o


def _states_equal(a, b):
    keys = [k for k in a if not k.endswith("num_batches_tracked")]
    assert set(keys) == {k for k in b if not k.endswith("num_batches_tracked")}
    for k in keys:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("ief", [True, False], ids=["IEF", "IMNet"])
def test_stage1_import_is_bit_for_bit_the_jax_converter(ief):
    """Every parameter and buffer bit for bit those of JAX's converter
    followed by ``lidf_from_jax``; the model built to the file's widths and
    decoder type."""
    ckpt = ref_stage1(1, ief)
    got = ti.build_from_reference(ckpt)
    assert type(got.offset_dec).__name__ == ("IEF" if ief else "IMNet")
    assert got.remat_backbone is False and got.fused == ief
    params, stats, meta = convert_lidf_checkpoint(_np_ckpt(ckpt))
    cfg = load_config(overrides=port_cfg("IEF" if ief else "IMNET"))
    want = lidf_from_jax({"params": params, "batch_stats": stats},
                         build_lidf(cfg, build_static(cfg)))
    _states_equal(got.state_dict(), want.state_dict())
    assert ti.meta_of(ckpt) == meta


@pytest.mark.parametrize("ief", [True, False], ids=["IEF", "IMNet"])
def test_stage2_import_is_bit_for_bit_the_jax_converter(ief):
    ckpt = ref_stage2(2, ief)
    got = ti.build_from_reference(ckpt, rgb_out=RGB)
    params, _, meta = convert_refine_checkpoint(_np_ckpt(ckpt), rgb_out=RGB)
    cfg = load_config(overrides=port_cfg("IEF" if ief else "IMNET"))
    want = refine_from_jax(params, build_refine(cfg, build_static(cfg)))
    _states_equal(got.state_dict(), want.state_dict())
    # JAX's converter drops a numpy float32 scalar (not a python float); the
    # port keeps it
    assert meta == {"epoch": 29}
    assert ti.meta_of(ckpt) == {"epoch": 29,
                                "xyz_err": float(np.float32(0.04))}


def test_no_posenc_file_builds_a_model_without_posenc():
    """A layer 1 as wide as the embedding without positional encoding: the
    model is built with ``pos_encode`` false, in both stages."""
    m1 = ti.build_from_reference(ref_stage1(3, True, PNET + RGB * 4 + 9))
    m2 = ti.build_from_reference(ref_stage2(3, True, PNET + RGB * 4 + 6),
                                 rgb_out=RGB)
    assert not m1.pos_encode and not m2.pos_encode
    with pytest.raises(ValueError, match="fits neither"):
        ti.build_from_reference(ref_stage1(3, True, EMBED1 + 1))


def test_every_tensor_comes_from_the_file():
    """Two models of different random weights load the same file to the
    same bits: nothing keeps a value of its own."""
    ckpt = ref_stage1(4)
    cfg = load_config(overrides=port_cfg())
    a = build_lidf(cfg, build_static(cfg), torch.Generator().manual_seed(1))
    b = build_lidf(cfg, build_static(cfg), torch.Generator().manual_seed(2))
    _states_equal(ti.load_reference(a, ckpt).state_dict(),
                  ti.load_reference(b, ckpt).state_dict())


def test_a_file_that_does_not_fit_raises_with_the_name():
    cfg = load_config(overrides=port_cfg())
    model = build_lidf(cfg, build_static(cfg))
    # an IMNet file into an IEF model: the encoder is missing
    with pytest.raises(ValueError, match="offset_dec.offset_enc.weight"):
        ti.load_reference(model, ref_stage1(5, ief=False))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    # another width: the PointNet's output (and so the decoders' layer 1)
    wide = ref_stage1(5)
    wide["pnet_model"] = ref_pointnet(torch.Generator().manual_seed(0), 32)
    with pytest.raises(ValueError, match=r"pnet.l1.bias: shape \(16,\)"):
        ti.load_reference(model, wide)
    # a tensor the model has no place for, and one the file lacks
    extra = ref_stage1(5)
    extra["prob_dec"]["linear_5.weight"] = torch.zeros(1, 1)
    with pytest.raises(ValueError, match="linear_5.weight"):
        ti.load_reference(model, extra)
    short = ref_stage1(5)
    del short["resnet_model"]["resnet34_8s.layer2.0.bn2.running_var"]
    with pytest.raises(ValueError, match="layer2.0.bn2.running_var"):
        ti.load_reference(model, short)
    unknown = {**ref_stage1(5), "scheduler": {"x": torch.zeros(1)}}
    with pytest.raises(ValueError, match="scheduler"):
        ti.load_reference(model, unknown)
    # nothing half-loaded
    _states_equal(model.state_dict(), before)
    ief_refine = build_refine(cfg, build_static(cfg))
    with pytest.raises(ValueError, match="offset_enc"):
        ti.load_reference(ief_refine, ref_stage2(5, ief=False))


@pytest.fixture(scope="module")
def imported(tmp_path_factory):
    """Both stages saved as reference .pth files (num_batches_tracked,
    optimizer entries, numpy metric scalars) and converted by the tool."""
    base = tmp_path_factory.mktemp("imported")
    out = {}
    for ief in (True, False):
        tag = "ief" if ief else "imnet"
        s1, s2 = ref_stage1(11, ief), ref_stage2(12, ief)
        for stage, ck in (("lidf", s1), ("refine", s2)):
            pth = base / f"{tag}_{stage}.pth"
            torch.save(ck, pth)
            d = str(base / f"{tag}_{stage}_ckpt")
            import_torch_ckpt.main(["--pth", str(pth), "--out", d,
                                    "--rgb_out", str(RGB)])
            out[(tag, stage)] = (d, ck)
    return base, out


def test_the_tool_writes_the_files_epoch_and_scalars(imported):
    _, out = imported
    d, ck = out[("ief", "lidf")]
    meta = Checkpointer(d)._read_meta(d + "/latest_network")
    assert meta == {"epoch": 59, "xyz_err": 0.05, "acc": 0.5}
    raw = torch.load(d + "/latest_network/state.pt", weights_only=True)
    assert raw["optimizer"] is None and raw["step"] == 0
    _states_equal(raw["model"], ti.build_from_reference(ck).state_dict())
    with pytest.raises(Exception):  # the metrics' numpy scalars
        torch.load(str(imported[0] / "ief_lidf.pth"), weights_only=True)
    assert ti.read_checkpoint(str(imported[0] / "ief_lidf.pth"))["epoch"] == 59


@pytest.mark.parametrize("tag", ["ief", "imnet"])
def test_imported_two_stage_serves_as_jax(imported, tag):
    """``DepthCompleter.from_checkpoint`` on the two imported directories
    against JAX's ``DepthCompleter`` on the JAX-converted trees: the serving
    tests' 1e-4; input depth bit for bit."""
    _, out = imported
    (d1, c1), (d2, c2) = out[(tag, "lidf")], out[(tag, "refine")]
    o = port_cfg("IEF" if tag == "ief" else "IMNET")
    dc = DepthCompleter.from_checkpoint(d1, d2, cfg=load_config(overrides=o),
                                        device="cpu")
    params, stats, _ = convert_lidf_checkpoint(_np_ckpt(c1))
    rparams = convert_refine_checkpoint(_np_ckpt(c2), rgb_out=RGB)[0]
    jdc = JaxDepthCompleter(jax_load_config(overrides=o),
                            lidf_variables={"params": params,
                                            "batch_stats": stats},
                            refine_params=rparams)
    rgb, depth, intr = _frame(H, W, 13)
    got = dc.complete(rgb, depth, intr)
    want = jdc.complete(rgb, depth, intr)
    have = depth != 0
    assert got["depth"][have].tobytes() == depth[have].tobytes()
    for key in ("depth", "depth_pred"):
        np.testing.assert_allclose(got[key], np.asarray(want[key]),
                                   atol=1e-4, rtol=0, err_msg=key)
    assert np.ptp(got["depth_pred"]) > 0.1


def test_imported_directories_load_as_checkpoint_and_lidf_ckpt_path(
        imported, tmp_path):
    """``checkpoint_path`` (stage 1 and stage 2) and ``lidf_ckpt_path``
    through the CLI's trainers: the built models hold the file's tensors."""
    _, out = imported
    (d1, c1), (d2, c2) = out[("imnet", "lidf")], out[("imnet", "refine")]
    cfg_path = str(tmp_path / "cfg.yaml")
    load_config(overrides=port_cfg("IMNET")).save(cfg_path)
    common = ["--device", "cpu", "--cfg_paths", cfg_path, "--set",
              f"base_log_dir={tmp_path}", "dataset.type=synthetic",
              "exp_type=test"]
    t1 = port_main.make_trainer([*common, "log_name=l", "trainer_name=lidf",
                                 f"checkpoint_path={d1}"])
    _states_equal(t1.model.state_dict(),
                  ti.build_from_reference(c1).state_dict())
    t2 = port_main.make_trainer([*common, "log_name=r", "trainer_name=refine",
                                 f"checkpoint_path={d2}",
                                 f"lidf_ckpt_path={d1}"])
    _states_equal(t2.lidf_model.state_dict(),
                  ti.build_from_reference(c1).state_dict())
    _states_equal(t2.refine_model.state_dict(),
                  ti.build_from_reference(c2, rgb_out=RGB).state_dict())


def test_roi_permutation_is_the_jax_converters():
    from implicit_depth_tpu.utils.torch_import import (
        roi_row_permutation as jax_perm,
    )
    for args in ((128, 32, 4), (16, 8, 4), (0, 3, 9)):
        np.testing.assert_array_equal(ti.roi_row_permutation(*args),
                                      jax_perm(*args))


def test_palette_frame_serves_as_jax_on_the_jax_feed(weights, tmp_path):
    """The serving margin of a palette PNG frame (1 pixel of 3,072 at
    1.03e-4 from JAX through both complete_depth scripts, the same 1.03e-4
    with both packages run in float64) comes from the JAX DepthCompleter's
    packed feed, which ships the standardized RGB as float16 and the depth
    as 16-bit fixed point (``train/feed.py``): fed that batch, the port's
    prediction is within 1e-5 of JAX's at every pixel (1.0e-6 measured:
    f32 order), where its own exact f32 feed lands further away."""
    lvars, rparams = weights
    rng = np.random.default_rng(12)
    img = Image.fromarray(rng.integers(0, 40, (H, W), np.uint8), "P")
    img.putpalette(rng.integers(0, 256, 120, np.uint8).tolist())
    path = str(tmp_path / "palette.png")
    img.save(path)
    rgb = port_complete.load_rgb(path)
    _, depth, intr = _frame(H, W, 11)
    cfg, lidf, refine = _port_pair(lvars, rparams)
    dc = DepthCompleter(cfg, lidf=lidf, refine=refine, device="cpu")
    jdc = JaxDepthCompleter(jax_load_config(overrides=serve_overrides()),
                            lidf_variables=lvars, refine_params=rparams)
    want = np.asarray(jdc.complete(rgb, depth, intr)["depth_pred"])
    sample, _ = jdc._prep_frame(rgb, depth, intr)
    f32, f16, u16, spec = pack_batch({k: np.stack([v]) for k, v in
                                      sample.items()}, derive_xyz=True)
    fed = jax.jit(unpack_for_spec(spec))(fuse_bytes(f32, f16, u16))
    on_jax_feed = dc.forward({k: torch.from_numpy(np.array(v))
                              for k, v in fed.items()})[1][0].numpy()
    exact = dc.complete(rgb, depth, intr)["depth_pred"]
    np.testing.assert_allclose(on_jax_feed, want, atol=1e-5, rtol=0)
    assert np.abs(exact - want).max() > 1e-4
