"""The port's disk path against the JAX package's, on the CPU: the tree that
``implicit_depth_torch.tools.make_disk_datasets`` writes against
``scripts/make_disk_datasets.py``'s at the same seed, both packages'
loaders on the port-written tree, the port's datasets with OpenCV, Pillow
and h5py blocked, ``tools/complete_depth.py`` against
``scripts/complete_depth.py``, and serving a frame at twice the model's
size (uint8 through OpenCV's bilinear resize) against JAX's."""

import importlib.util
import json
import os
import os.path as osp
import subprocess
import sys

import cv2
import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_port_data import CUBIC_ATOL, CUBIC_RTOL, assert_samples_equal
from test_torch_port_slice import randomize

from implicit_depth_torch.builder import build_lidf, build_refine, build_static
from implicit_depth_torch.config import load_config
from implicit_depth_torch.data import datasets as port_ds
from implicit_depth_torch.data.exr import read_exr
from implicit_depth_torch.infer import DepthCompleter
from implicit_depth_torch.tools import compare_epoch_logs
from implicit_depth_torch.tools import complete_depth as port_complete
from implicit_depth_torch.tools import make_disk_datasets as port_make
from implicit_depth_torch.tools import quality_r5
from implicit_depth_torch.train.checkpoint import Checkpointer
from implicit_depth_torch.weights import lidf_from_jax, refine_from_jax
from implicit_depth_tpu.builder import build_lidf as jax_build_lidf
from implicit_depth_tpu.builder import build_refine as jax_build_refine
from implicit_depth_tpu.builder import build_static as jax_build_static
from implicit_depth_tpu.config import load_config as jax_load_config
from implicit_depth_tpu.data import datasets as jax_ds
from implicit_depth_tpu.data.synthetic import synthetic_batch
from implicit_depth_tpu.infer import DepthCompleter as JaxDepthCompleter
from implicit_depth_tpu.models import lidf as jlidf
from implicit_depth_tpu.train.checkpoint import Checkpointer as JaxCheckpointer
from implicit_depth_tpu.train.state import TrainState, make_tx

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
sys.path.insert(0, osp.join(REPO, "scripts"))

torch.set_num_threads(2)
H_SRC, W_SRC = 96, 128
COUNTS = dict(n_train=3, n_val=2, n_test=2)


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        name, osp.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _write_jax_tree(root, seed):
    m = _jax_script("make_disk_datasets")
    rng, hw = np.random.default_rng(seed), (H_SRC, W_SRC)
    cg, n = osp.join(root, "cleargrasp"), COUNTS
    m.write_cleargrasp_syn(osp.join(cg, "cleargrasp-dataset-train"),
                           n["n_train"], rng, hw)
    for split, k in (("synthetic-val", "n_val"), ("synthetic-test", "n_test")):
        m.write_cleargrasp_syn(osp.join(cg, "cleargrasp-dataset-test-val",
                                        split), n[k], rng, hw)
    m.write_cleargrasp_real(osp.join(cg, "cleargrasp-dataset-test-val",
                                     "real-val"), n["n_val"], rng, hw, "d415")
    m.write_cleargrasp_real(osp.join(cg, "cleargrasp-dataset-test-val",
                                     "real-test"), n["n_test"], rng, hw,
                            "d435")
    m.write_omniverse(osp.join(root, "omniverse", "train"), n["n_train"],
                      rng, hw)
    m.write_omniverse(osp.join(root, "omniverse", "small_test"),
                      n["n_test"], rng, hw)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    port = str(tmp_path_factory.mktemp("port_tree"))
    jax_root = str(tmp_path_factory.mktemp("jax_tree"))
    port_make.main(["--out", port, "--seed", "7", "--src_h", str(H_SRC),
                    "--src_w", str(W_SRC),
                    *[f"--{k}={v}" for k, v in COUNTS.items()]])
    _write_jax_tree(jax_root, 7)
    return port, jax_root


def _files(root):
    return sorted(osp.relpath(osp.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _psnr(a, b):
    err = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0 ** 2 / err)


def test_generator_writes_the_jax_scripts_scenes(trees):
    """The same files; EXR depth, masks, HDF5 arrays, JSON and YAML the same
    values; the JPEGs within the encoder's bound of their sources (no
    further than cv2's own encode of the same scene, plus 1 dB)."""
    port, jax_root = trees
    names = _files(port)
    assert names == _files(jax_root)
    jpgs = [n for n in names if n.endswith(".jpg")]
    for name in names:
        p, j = osp.join(port, name), osp.join(jax_root, name)
        if name.endswith(".exr"):
            got, want = read_exr(p), read_exr(j)
            assert set(got) == set(want)
            for k in got:
                np.testing.assert_array_equal(got[k], want[k], err_msg=name)
        elif name.endswith(".png"):
            np.testing.assert_array_equal(np.array(Image.open(p)),
                                          np.array(Image.open(j)))
            assert Image.open(p).mode == Image.open(j).mode == "P"
        elif name.endswith(".h5"):
            with h5py.File(p, "r") as fp, h5py.File(j, "r") as fj:
                keys = []
                fj.visititems(lambda n, o: keys.append(n)
                              if isinstance(o, h5py.Dataset) else None)
                for k in keys:
                    assert fp[k].dtype == fj[k].dtype, (name, k)
                    np.testing.assert_array_equal(fp[k][()], fj[k][()])
        elif name.endswith(".json"):
            assert json.load(open(p)) == json.load(open(j))
        elif name.endswith(".yaml"):
            assert open(p).read() == open(j).read()
    # the scenes' uint8 RGB, from the port's list of the tree's contents
    sources = {osp.relpath(path, "tree"): rgb for path, rgb in
               port_make.tree_files("tree", src_hw=(H_SRC, W_SRC), seed=7,
                                    **COUNTS) if path.endswith(".jpg")}
    assert sorted(sources) == jpgs
    for name, src in sources.items():
        ours = cv2.imread(osp.join(port, name))[..., ::-1]
        theirs = cv2.imread(osp.join(jax_root, name))[..., ::-1]
        assert _psnr(ours, src) >= _psnr(theirs, src) - 1.0, name


# (dataset type, exp_type, obj_type)
CASES = [("cleargrasp_synthetic", "train", "known"),
         ("cleargrasp_synthetic", "valid", "novel"),
         ("cleargrasp_real", "valid", "known"),
         ("cleargrasp_real", "test", "novel"),
         ("omniverse", "train", "known"), ("omniverse", "test", "known"),
         ("mixed", "train", "known")]


def _overrides(root, kind):
    return {"dataset": {
        "type": kind, "cleargrasp_root_dir": osp.join(root, "cleargrasp"),
        "omniverse_root_dir": osp.join(root, "omniverse"),
        "img_width": 64, "img_height": 48, "use_data_augmentation": True,
        "depth_aug": True, "corrupt_table": True}}


@pytest.mark.parametrize("kind,exp_type,obj_type", CASES,
                         ids=[f"{c[0]}-{c[1]}-{c[2]}" for c in CASES])
def test_both_loaders_read_the_port_tree_alike(trees, kind, exp_type,
                                               obj_type):
    """The JAX package's datasets (OpenCV, Pillow, h5py) and the port's read
    the files the port wrote to the same samples (augmented train samples'
    xyz_corrupt within the INTER_CUBIC bound of test_torch_port_data.py)."""
    ov = _overrides(trees[0], kind)
    ds = port_ds.get_dataset(load_config(overrides=ov).dataset, exp_type,
                             obj_type, base_seed=3)
    jds = jax_ds.get_dataset(jax_load_config(overrides=ov).dataset,
                             exp_type, obj_type, base_seed=3)
    assert len(ds) == len(jds) > 0
    near = {"xyz_corrupt"} if exp_type == "train" else ()
    for idx in range(len(ds)):
        assert_samples_equal(ds.__getitem__(idx, 1), jds.__getitem__(idx, 1),
                             near)


_BLOCKED = """
import sys
for name in ("cv2", "PIL", "h5py", "jax"):
    sys.modules[name] = None
import numpy as np
from implicit_depth_torch.config import load_config
from implicit_depth_torch.data.datasets import get_dataset
root, out = sys.argv[1], sys.argv[2]
arrays = {}
for kind, exp_type, obj_type in %r:
    ds = get_dataset(load_config(overrides={"dataset": {
        "type": kind, "cleargrasp_root_dir": root + "/cleargrasp",
        "omniverse_root_dir": root + "/omniverse", "img_width": 64,
        "img_height": 48, "use_data_augmentation": True, "depth_aug": True,
        "corrupt_table": True}}).dataset, exp_type, obj_type, base_seed=3)
    for idx in range(len(ds)):
        for k, v in ds.__getitem__(idx, 1).items():
            if k != "item_path":
                arrays[f"{kind}-{exp_type}-{obj_type}-{idx}-{k}"] = v
np.savez(out, **arrays)
assert not {"cv2", "PIL", "h5py"} & {m for m in sys.modules if sys.modules[m]}
print("ok")
"""


def test_port_datasets_load_with_opencv_pillow_and_h5py_blocked(trees,
                                                                tmp_path):
    """A subprocess that cannot import cv2, PIL or h5py reads the JAX
    script's tree to the JAX package's samples."""
    root = trees[1]
    out = str(tmp_path / "samples.npz")
    run = subprocess.run([sys.executable, "-c", _BLOCKED % (CASES,), root,
                          out], cwd=REPO, capture_output=True, text=True,
                         timeout=600)
    assert run.returncode == 0 and run.stdout.strip().endswith("ok"), \
        run.stdout + run.stderr
    got = np.load(out)
    n = 0
    for kind, exp_type, obj_type in CASES:
        jds = jax_ds.get_dataset(
            jax_load_config(overrides=_overrides(root, kind)).dataset,
            exp_type, obj_type, base_seed=3)
        for idx in range(len(jds)):
            for k, v in jds.__getitem__(idx, 1).items():
                if k == "item_path":
                    continue
                key = f"{kind}-{exp_type}-{obj_type}-{idx}-{k}"
                assert got[key].dtype == np.asarray(v).dtype, key
                if exp_type == "train" and k == "xyz_corrupt":
                    np.testing.assert_allclose(got[key], v, rtol=CUBIC_RTOL,
                                               atol=CUBIC_ATOL, err_msg=key)
                else:
                    np.testing.assert_array_equal(got[key], v, err_msg=key)
                n += 1
    assert n == len(got.files)


# -- serving ------------------------------------------------------------------

H, W = 48, 64


def serve_overrides():
    return {
        "mask_type": "all",
        "dataset": {"img_height": H, "img_width": W},
        "model": {"rgb_out": 8, "pnet_out": 16, "pnet_gf": 8, "imnet_gf": 8,
                  "resnet_stages": [1, 1, 1, 1]},
        "refine": {"pnet_out": 16, "pnet_gf": 8, "imnet_gf": 8},
        "grid": {"res": 8, "valid_sample_num": -1},
        "tpu": {"max_pairs_per_ray": 12, "pairs_budget_per_ray": 8,
                "use_pallas_decode": False, "compute_dtype": "float32"},
    }


@pytest.fixture(scope="module")
def weights():
    """JAX variables at unit activation scale, both stages."""
    jcfg = jax_load_config(overrides=serve_overrides())
    jstatic = jax_build_static(jcfg, n_rays=H * W)
    jl, jr = jax_build_lidf(jcfg, jstatic), jax_build_refine(jcfg, jstatic)
    raw = synthetic_batch(71, 1, H, W)
    jin = jax.jit(lambda b, k: jlidf.prepare_inputs(
        jstatic, b, k, train=False))({k: jnp.asarray(v) for k, v in
                                      raw.items()}, jax.random.key(0))
    rng = np.random.default_rng(71)
    lvars = randomize(jax.device_get(jax.jit(lambda k, i: jl.init(
        k, i, train=False, use_gt_label=False))(jax.random.key(1), jin)), rng)
    lout = jax.jit(lambda v, i: jl.apply(v, i, train=False,
                                         use_gt_label=False))(lvars, jin)
    rparams = randomize(jax.device_get(jax.jit(lambda k, i, o: jr.init(
        k, i, o, o["pred_pos"]))(jax.random.key(2), jin, lout))["params"], rng)
    return lvars, rparams


def _port_pair(lvars, rparams):
    cfg = load_config(overrides=serve_overrides())
    static = build_static(cfg, n_rays=H * W)
    return (cfg, lidf_from_jax(lvars, build_lidf(cfg, static)),
            refine_from_jax(rparams, build_refine(cfg, static)))


def _frame(h, w, seed):
    depth = np.asarray(synthetic_batch(seed, 1, h, w)["depth_corrupt"][0])
    rgb = np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)
    return rgb, depth, (80.0 * w / W, 80.0 * h / H, w / 2, h / 2)


def test_complete_at_twice_the_size_matches_jax(weights):
    """A uint8 frame at (2H, 2W): OpenCV's bilinear resize keeps uint8 (and
    at exactly half size is the 2x2 mean, rounded), as JAX serves it. The
    depth is the serving tests' frame (synthetic_batch(71)) at twice its
    size; both stages, held to the serving tests' 1e-4 against JAX
    (test_torch_port_rays_cli.py); input depth bit for bit."""
    lvars, rparams = weights
    cfg, lidf, refine = _port_pair(lvars, rparams)
    raw = synthetic_batch(71, 1, H, W)
    depth = np.repeat(np.repeat(np.asarray(raw["depth_corrupt"][0]), 2, 0),
                      2, 1)
    rgb = np.random.default_rng(71).integers(0, 256, (2 * H, 2 * W, 3),
                                             np.uint8)
    intr = tuple(2 * float(raw[k][0]) for k in ("fx", "fy", "cx", "cy"))
    got = DepthCompleter(cfg, lidf=lidf, refine=refine,
                         device="cpu").complete(rgb, depth, intr)
    want = JaxDepthCompleter(jax_load_config(overrides=serve_overrides()),
                             lidf_variables=lvars,
                             refine_params=rparams).complete(rgb, depth, intr)
    assert got["depth"].shape == (2 * H, 2 * W)
    have = depth != 0
    assert have.any() and (~have).any()
    assert got["depth"][have].tobytes() == depth[have].tobytes()
    for key in ("depth", "depth_pred"):
        np.testing.assert_allclose(got[key], np.asarray(want[key]),
                                   atol=1e-4, rtol=0, err_msg=key)


@pytest.fixture(scope="module")
def checkpoints(weights, tmp_path_factory):
    """The same weights as the JAX package's orbax checkpoints and as the
    port's, and the config both CLIs read."""
    lvars, rparams = weights
    base = tmp_path_factory.mktemp("complete_depth")
    jcfg = jax_load_config(overrides=serve_overrides())
    tx = make_tx(jcfg.training, 10)
    dirs = {k: str(base / k) for k in ("jl", "jr", "pl", "pr")}
    JaxCheckpointer(dirs["jl"]).save(TrainState.create(
        lvars["params"], lvars["batch_stats"], tx), 0)
    JaxCheckpointer(dirs["jr"]).save(TrainState.create(rparams, {}, tx), 0)
    _, lidf, refine = _port_pair(lvars, rparams)
    Checkpointer(dirs["pl"]).save(lidf, epoch=0)
    Checkpointer(dirs["pr"]).save(refine, epoch=0)
    cfg_path = str(base / "cfg.yaml")  # the port's dump; pyyaml reads it
    load_config(overrides=serve_overrides()).save(cfg_path)
    return dirs, cfg_path


@pytest.mark.parametrize("depth_fmt,rgb_fmt,out_fmt",
                         [("npy", "png", "npy"), ("exr", "jpg", "npy"),
                          ("png", "jpg", "png")])
def test_complete_depth_tool_matches_the_jax_script(checkpoints, tmp_path,
                                                    depth_fmt, rgb_fmt,
                                                    out_fmt):
    """``tools/complete_depth.py`` against ``scripts/complete_depth.py``
    (as ``tests/test_infer.py``'s CLI case), both stages, on the same files:
    the 1e-4 of the serving tests for .npy out, one millimetre for a 16-bit
    PNG (a value near a millimetre's edge may round either way); input depth
    bit for bit (through millimetres for a PNG)."""
    from implicit_depth_torch.data.exr import write_exr
    dirs, cfg_path = checkpoints
    rgb, depth, intr = _frame(H, W, 11)
    if depth_fmt == "png":  # millimetres, as a depth camera writes them
        depth = np.round(depth * 1000.0).astype(np.uint16).astype(
            np.float32) / 1000.0
    paths = {"rgb": str(tmp_path / f"f-rgb.{rgb_fmt}"),
             "depth": str(tmp_path / f"f-depth.{depth_fmt}")}
    cv2.imwrite(paths["rgb"], cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR))
    if depth_fmt == "npy":
        np.save(paths["depth"], depth)
    elif depth_fmt == "exr":
        write_exr(paths["depth"], {"R": depth})
    else:
        cv2.imwrite(paths["depth"], np.round(depth * 1000.0).astype(
            np.uint16))
    common = ["--cfg_paths", cfg_path, "--rgb", paths["rgb"], "--depth",
              paths["depth"], "--fx", str(intr[0]), "--fy", str(intr[1]),
              "--cx", str(intr[2]), "--cy", str(intr[3])]
    outs = {k: str(tmp_path / f"{k}.{out_fmt}") for k in ("port", "jax")}
    port_complete.main(["--lidf_ckpt", dirs["pl"], "--refine_ckpt",
                        dirs["pr"], "--device", "cpu", "--out", outs["port"],
                        *common])
    _jax_script("complete_depth").main([
        "--lidf_ckpt", dirs["jl"], "--refine_ckpt", dirs["jr"], "--out",
        outs["jax"], *common])
    if out_fmt == "npy":
        got, want = np.load(outs["port"]), np.load(outs["jax"])
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
        have = depth != 0
        assert got[have].tobytes() == depth[have].tobytes()
    else:
        got = cv2.imread(outs["port"], cv2.IMREAD_UNCHANGED)
        want = cv2.imread(outs["jax"], cv2.IMREAD_UNCHANGED)
        assert got.dtype == want.dtype == np.uint16
        assert np.abs(got.astype(np.int64) - want).max() <= 1
        have = depth != 0
        np.testing.assert_array_equal(
            got[have], (depth[have] * 1000.0).astype(np.uint16))
    assert (got != 0).all()


@pytest.mark.parametrize("kind", ["palette", "grey", "grey16", "grey_alpha",
                                  "rgb", "rgba", "rgb16"])
def test_complete_depth_tool_reads_rgb_pngs_as_cv2(tmp_path, kind):
    """``load_rgb`` on each PNG kind gives the bits of ``cv2.imread``
    (IMREAD_COLOR) and BGR2RGB, as ``scripts/complete_depth.py`` reads the
    frame: a palette image in its palette's colours, 16-bit grey and colour
    by their high bytes."""
    rng = np.random.default_rng(12)
    path = str(tmp_path / f"{kind}.png")
    if kind == "palette":
        img = Image.fromarray(rng.integers(0, 40, (13, 17), np.uint8), "P")
        img.putpalette(rng.integers(0, 256, 120, np.uint8).tolist())
        img.save(path)
    else:
        shape = {"grey": (13, 17), "grey_alpha": (13, 17, 2),
                 "rgb": (13, 17, 3), "rgba": (13, 17, 4)}.get(kind)
        if kind.endswith("16"):
            img = rng.integers(0, 65536, (13, 17, 3)[:2 + (kind == "rgb16")],
                               np.uint16)
        else:
            img = rng.integers(0, 256, shape, np.uint8)
        mode = {"grey_alpha": "LA", "rgba": "RGBA"}.get(kind)
        if mode:  # cv2 writes no grey + alpha; Pillow writes both as stored
            Image.fromarray(img, mode).save(path)
        else:
            cv2.imwrite(path, img)
    got = port_complete.load_rgb(path)
    want = cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def _quality_runs(monkeypatch, argv):
    """quality_r5.main with its runs recorded, not started: (exit code,
    [(name, command)])."""
    ran = []
    monkeypatch.setattr(quality_r5, "run", lambda cmd, log, timings, name:
                        ran.append((name, cmd)))
    return quality_r5.main(argv), ran


def test_quality_tool_runs_the_recipe(trees, tmp_path, monkeypatch):
    """The runs of ``scripts/run_disk_r5.sh``'s recipe, in order, on the
    device asked for: the 560 / 56 / 56 dataset at seed 0 only where
    ``--data`` does not exist; every training and test run's config loads
    with its overrides."""
    from implicit_depth_torch.main import parse_overrides
    port, _ = trees
    logs = str(tmp_path / "logs")
    _, ran = _quality_runs(monkeypatch, ["--data", str(tmp_path / "new"),
                                         "--logs", logs, "--device", "cpu"])
    names = ["stage1", "refine_hardneg", "refine_plain", "test_lidf_only",
             "test_refine_hardneg", "test_refine_plain"]
    assert [n for n, _ in ran] == ["dataset", "manifest", *names]
    assert ran[0][1][-4:] == ["0", "--n_train=560", "--n_val=56",
                              "--n_test=56"]
    _, ran = _quality_runs(monkeypatch, ["--data", port, "--logs", logs,
                                         "--device", "cpu"])
    assert [n for n, _ in ran] == names
    epochs = {"stage1": 60, "refine_hardneg": 30, "refine_plain": 30}
    for name, cmd in ran:
        assert cmd[cmd.index("--device") + 1] == "cpu"
        sets = cmd[cmd.index("--set") + 1:]
        cfg = load_config(cmd[cmd.index("--cfg_paths") + 1],
                          overrides=parse_overrides(sets))
        assert cfg.dataset.cleargrasp_root_dir == f"{port}/cleargrasp"
        assert cfg.dataset.omniverse_root_dir == f"{port}/omniverse"
        if name in epochs:
            assert cfg.exp_type == "train"
            assert cfg.training.nepochs == epochs[name]
            assert cfg.training.batch_size == 4
        else:
            assert cfg.exp_type == "test"


@pytest.mark.parametrize("epochs,worse,rc", [
    ((60, 30), False, 0), ((60, 30), True, 1), ((12, 6), True, 0)])
def test_quality_tool_exits_with_the_gate(trees, tmp_path, monkeypatch,
                                          epochs, worse, rc):
    """At the recipe's epochs the tool's exit code is the round-5 gate's
    (``scripts/summarize_quality.py --gate``): 0 on the targets' own table,
    nonzero on a table that misses them; a cut run exits 0 and says it is
    a trend, not the gate."""
    port, _ = trees
    logs = tmp_path / "logs"
    with open(osp.join(REPO, "docs", "quality_targets_r5.json")) as f:
        targets = json.load(f)
    for key, t in targets.items():
        variant, split = key.split("/")
        d = logs / variant / "result"
        d.mkdir(parents=True, exist_ok=True)
        rmse, a1 = t["rmse"] + 0.1 * worse, t["a1"] - 0.1 * worse
        (d / f"{split}.csv").write_text(
            "name,rmse,rel,mae,a1,a2,a3\n"
            f"0,{rmse},{t['rel']},{t['mae']},{a1},{t['a2']},{t['a3']}\n")
    got, _ = _quality_runs(monkeypatch, [
        "--data", port, "--logs", str(logs), "--device", "cpu",
        "--lidf_epochs", str(epochs[0]), "--refine_epochs", str(epochs[1])])
    assert got == rc
    summary = (logs / "summary.txt").read_text()
    assert ("QUALITY REGRESSIONS" in summary) == worse
    assert ("a trend, not the gate" in summary) == (epochs != (60, 30))


def test_quality_tool_runs_stage1_alone(trees, tmp_path, monkeypatch):
    """``--only stage1``: the dataset (where ``--data`` does not exist) and
    stage 1 at the epochs asked for, no stage 2, no test run and no
    summary; exit 0."""
    port, _ = trees
    logs = tmp_path / "logs"
    rc, ran = _quality_runs(monkeypatch, [
        "--data", str(tmp_path / "new"), "--logs", str(logs), "--device",
        "cpu", "--lidf_epochs", "16", "--only", "stage1"])
    assert rc == 0
    assert [n for n, _ in ran] == ["dataset", "manifest", "stage1"]
    assert "training.nepochs=16" in ran[-1][1]
    assert not (logs / "summary.txt").exists()
    _, ran = _quality_runs(monkeypatch, ["--data", port, "--logs", str(logs),
                                         "--device", "cpu", "--only",
                                         "stage1"])
    assert [n for n, _ in ran] == ["stage1"]


JAX_EPOCH_LOG = osp.join(REPO, "docs", "results_disk_r5",
                         "lidf60_epoch_log.jsonl")


@pytest.mark.parametrize("case,rc", [("itself", 0), ("rmse 20% up", 1),
                                     ("a1 30% down", 1), ("no common", 2)])
def test_compare_epoch_logs_exits_with_its_rule(tmp_path, capsys, case, rc):
    """``tools/compare_epoch_logs.py`` on JAX's round-5 epoch log: against
    itself it tracks (exit 0); a copy with one split's rmse raised 20% at
    every epoch misses the 1.15x rule, one with a split's a1 cut 30% the
    0.75x rule (exit 1); a log with no common validated epoch exits 2. The
    side-by-side table names every common epoch."""
    lines = [json.loads(x) for x in open(JAX_EPOCH_LOG) if x.strip()]
    for rec in lines:
        v = rec.get("valid", {})
        if case == "rmse 20% up" and v:
            v["real_known"]["rmse"] *= 1.2
        if case == "a1 30% down" and v:
            v["synthetic_novel"]["a1"] *= 0.7
        if case == "no common":
            rec["epoch"] += 1000
    run = tmp_path / "epoch_log.jsonl"
    run.write_text("".join(json.dumps(r) + "\n" for r in lines))
    got = compare_epoch_logs.main([str(run), JAX_EPOCH_LOG])
    out = capsys.readouterr().out
    assert got == rc
    if rc == 2:
        return
    epochs = [r["epoch"] for r in lines if "valid" in r]
    assert epochs[:6] == [0, 3, 6, 9, 12, 15]
    for e in epochs:
        assert f"| {e} |" in out
    missed = {"itself": None, "rmse 20% up": "real_known: lowest rmse",
              "a1 30% down": "synthetic_novel: lowest rmse"}[case]
    assert ("MISSED" in out) == (missed is not None)
    assert out.strip().endswith("tracks the reference" if rc == 0 else
                                "does not track the reference")
    if case == "a1 30% down":
        assert "highest a1" in out and out.count("MISSED") == 1
