"""The port's two-stage serving slice against the JAX package, on the CPU.

prepare_inputs -> LIDFModel -> two RefineModel iterations on a synthetic
batch, with the same (randomized) weights carried across by
``implicit_depth_torch.weights`` and the JAX draw of the valid points passed
in. The JAX side decodes through its plain XLA paths (use_pallas_decode off).
Also: DepthCompleter passthrough, the import boundary, and the device rule.
"""

import ast
import pathlib

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
from implicit_depth_tpu.models.lidf import prepare_inputs as jax_prepare_inputs
from implicit_depth_torch.builder import build_lidf, build_refine, build_static
from implicit_depth_torch.config import load_config
from implicit_depth_torch.infer import DepthCompleter
from implicit_depth_torch.models.lidf import prepare_inputs
from implicit_depth_torch.weights import lidf_from_jax, refine_from_jax

torch.set_num_threads(2)
# a first torch.sin before any JAX computation (see test_torch_port_ops.py)
torch.sin(torch.zeros(1 << 16))
H, W = 48, 64
REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("name", [None, *sorted(
    p.name for p in (REPO / "configs").glob("*.yaml"))])
def test_config_copy_loads_the_same(name):
    paths = [] if name is None else [str(REPO / "configs" / name)]
    assert (load_config(*paths).to_dict()
            == jax_load_config(*paths).to_dict())


def tiny_overrides(dtype):
    # K=12 > kb=8: the per_ray ray-major decode (K=kb takes the dense path)
    return {
        "mask_type": "all",
        "dataset": {"img_height": H, "img_width": W},
        "model": {"rgb_out": 8, "pnet_out": 16, "pnet_gf": 8, "imnet_gf": 8,
                  "resnet_stages": [1, 1, 1, 1]},
        "refine": {"pnet_out": 16, "pnet_gf": 8, "imnet_gf": 8},
        "grid": {"res": 8, "miss_sample_num": 256, "valid_sample_num": 512},
        "tpu": {"max_pairs_per_ray": 12, "pairs_budget_per_ray": 8,
                "use_pallas_decode": False, "compute_dtype": dtype},
    }


def randomize(tree, rng):
    """Replace every leaf with O(1)-activation random values: the flax
    initialisers' tiny decoder weights make every slot's logit nearly equal,
    and near-ties would hide the comparison."""
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
    return (0.1 * rng.normal(size=a.shape)).astype(np.float32)  # bias, mean


def run_slice(dtype):
    """Both frameworks on one batch -> (jax outputs, port outputs) as numpy."""
    jcfg = jax_load_config(overrides=tiny_overrides(dtype))
    jstatic = jax_build_static(jcfg, n_rays=H * W)
    jlidf, jref = jax_build_lidf(jcfg, jstatic), jax_build_refine(jcfg, jstatic)
    raw = synthetic_batch(3, 1, H, W)
    batch = {k: jnp.asarray(v) for k, v in raw.items()}
    jin = jax.jit(lambda b, k: jax_prepare_inputs(
        jstatic, b, k, train=False, mask_type="all"))(batch, jax.random.key(0))
    lvars = jax.jit(lambda k, i: jlidf.init(k, i, train=False,
                                            use_gt_label=False))(
        jax.random.key(1), jin)
    rng = np.random.default_rng(7)
    lvars = randomize(jax.device_get(lvars), rng)
    lout = jax.jit(lambda v, i: jlidf.apply(v, i, train=False,
                                            use_gt_label=False))(lvars, jin)
    rvars = jax.jit(lambda k, i, o: jref.init(k, i, o, o["pred_pos"]))(
        jax.random.key(2), jin, lout)
    rparams = randomize(jax.device_get(rvars["params"]), rng)

    @jax.jit
    def refine2(p, i, o):
        pred = o["pred_pos"]
        for _ in range(2):
            pred = jref.apply({"params": p}, i, o, pred)
        return pred

    jrefined = refine2(rparams, jin, lout)

    cfg = load_config(overrides=tiny_overrides(dtype))
    static = build_static(cfg, n_rays=H * W)
    lidf = lidf_from_jax(lvars, build_lidf(cfg, static)).eval()
    ref = refine_from_jax(rparams, build_refine(cfg, static)).eval()
    tb = {k: torch.from_numpy(np.array(v)) for k, v in raw.items()}
    with torch.no_grad():
        inp = prepare_inputs(static, tb, valid_idx=torch.from_numpy(
            np.array(jin["valid_idx"])))
        out = lidf(inp)
        pred = out["pred_pos"]
        for _ in range(2):
            pred = ref(inp, out, pred)
    jax_np = {k: np.asarray(v, np.float32) for k, v in
              {**jin, **lout, "refined": jrefined}.items()
              if k not in ("prob_softmax", "pair_pred_pos")}
    port_np = {k: v.float().numpy() for k, v in
               {**inp, **out, "refined": pred}.items()}
    return jax_np, port_np


@pytest.fixture(scope="module")
def slice_f32():
    return run_slice("float32")


@pytest.fixture(scope="module")
def slice_bf16():
    return run_slice("bfloat16")


@pytest.mark.parametrize("key", ["pair_cell", "pair_valid", "vox_cell_id",
                                 "occupancy", "valid_idx", "miss_px",
                                 "miss_py"])
def test_prepare_inputs_integer_outputs_equal(slice_f32, key):
    j, p = slice_f32
    np.testing.assert_array_equal(p[key], j[key])


@pytest.mark.parametrize("key", ["t_enter", "t_exit", "valid_xyz",
                                 "vox_rel_coord", "miss_dir"])
def test_prepare_inputs_float_outputs_match(slice_f32, key):
    j, p = slice_f32
    # the same f32 geometry; 1e-5: float rounding of the plane crossings
    np.testing.assert_allclose(p[key], j[key], atol=1e-5, rtol=0)


def test_slice_f32(slice_f32):
    j, p = slice_f32
    assert j["max_slot"].std() > 0  # the slots really compete
    np.testing.assert_array_equal(p["max_slot"], j["max_slot"])
    np.testing.assert_array_equal(p["has_pair"], j["has_pair"])
    # 1e-4: the same f32 algebra summed in another order through ResNet,
    # PointNet and both decoders
    np.testing.assert_allclose(p["prob_logit"], j["prob_logit"], atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(p["pred_pos"], j["pred_pos"], atol=1e-4, rtol=0)
    np.testing.assert_allclose(p["refined"], j["refined"], atol=1e-4, rtol=0)


def test_slice_bf16(slice_bf16):
    j, p = slice_bf16
    same = p["max_slot"] == j["max_slot"]
    # bf16 rounds at other places in the two frameworks (conv and dense
    # outputs, the refine IEF layer 1): a near-tie can pick another slot
    assert same.mean() >= 0.99, same.mean()
    # 0.05 (logits) and 0.02 m (positions, rays whose slot agrees): a few
    # bf16 ulps of the ~1-sized activations, through offsets scaled by
    # sqrt(3)·part_size = 0.43 m (stage 1) and 0.4 m (stage 2)
    np.testing.assert_allclose(p["prob_logit"], j["prob_logit"], atol=0.05,
                               rtol=0)
    np.testing.assert_allclose(p["pred_pos"][same], j["pred_pos"][same],
                               atol=0.02, rtol=0)
    np.testing.assert_allclose(p["refined"][same], j["refined"][same],
                               atol=0.02, rtol=0)


def _tiny_completer(device="cpu"):
    cfg = load_config(overrides=tiny_overrides("float32"))
    static = build_static(cfg, n_rays=H * W)
    g = torch.Generator().manual_seed(0)
    return DepthCompleter(cfg, lidf=build_lidf(cfg, static, g),
                          refine=build_refine(cfg, static, g), device=device)


@pytest.mark.parametrize("size", [(H, W), (2 * H, 2 * W)])
def test_complete_passes_input_depth_bit_for_bit(size):
    h0, w0 = size
    raw = synthetic_batch(5, 1, h0, w0)
    depth = np.asarray(raw["depth_corrupt"][0]) * np.float32(1.000001)
    rgb = np.random.default_rng(5).integers(0, 255, (h0, w0, 3), dtype=np.uint8)
    out = _tiny_completer().complete(rgb, depth, (80.0, 80.0, w0 / 2, h0 / 2))
    assert out["depth"].shape == (h0, w0)
    assert out["depth_pred"].shape == (H, W)
    assert np.isfinite(out["depth"]).all()
    have = depth != 0
    assert have.any() and (~have).any()
    assert out["depth"][have].tobytes() == depth[have].tobytes()


def test_cuda_device_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _tiny_completer(device="cuda")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in
    [*(REPO / "implicit_depth_torch").rglob("*.py"), REPO / "chip_smoke.py"]))
def test_port_imports_no_jax(path):
    # nor OpenCV, Pillow or h5py: the port's codecs and twins replace them
    banned = ("jax", "jaxlib", "flax", "optax", "orbax", "implicit_depth_tpu",
              "cv2", "PIL", "h5py")
    bad = [m for m in _imports(REPO / path) if m.split(".")[0] in banned]
    assert not bad, f"{path} imports {bad}"


# the layers above ops/: the kernels' wrappers and their operand format
# know nothing of the models, the training, serving or the mesh
ABOVE_OPS = ("models", "train", "infer", "parallel", "builder")


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO))
    for p in (REPO / "implicit_depth_torch").rglob("*.py")))
def test_port_layers_import_downward_and_public_names(path):
    """``ops/`` imports nothing from the layers above it, and no module of
    the port imports another module's ``_``-prefixed name."""
    tree = ast.parse((REPO / path).read_text(), filename=path)
    in_ops = pathlib.PurePath(path).parts[1] == "ops"
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module != "__future__":
            private = [a.name for a in node.names if a.name.startswith("_")]
            assert not private, \
                f"{path}:{node.lineno} imports {private} from {node.module}"
            names = [node.module or ""]
            names += [f"{node.module}.{a.name}" for a in node.names]
        else:
            continue
        if in_ops:
            up = [m for m in names if m.split(".")[:2] in (
                ["implicit_depth_torch", layer] for layer in ABOVE_OPS)]
            assert not up, f"{path}:{node.lineno} imports {up}"


# the card's machine has no OpenCV, Pillow or pyyaml (nor JAX): what the
# trainer and chip_smoke.py need must import and run without them
_BLOCKED_IMPORTS = """
import sys
for name in ("cv2", "PIL", "yaml", "jax", "h5py"):
    sys.modules[name] = None
import importlib, os, tempfile
for mod in ("implicit_depth_torch.main", "implicit_depth_torch.train.trainer",
            "implicit_depth_torch.data.loader",
            "implicit_depth_torch.data.datasets",
            "implicit_depth_torch.train.metrics",
            "implicit_depth_torch.train.visualize", "chip_smoke"):
    importlib.import_module(mod)
from implicit_depth_torch.config import load_config, load_yaml
from implicit_depth_torch.data.datasets import get_dataset
cfg = load_config("configs/train_lidf.yaml", overrides={"dataset": {
    "type": "synthetic", "synthetic_len": 2, "img_height": 24,
    "img_width": 32}})
path = os.path.join(tempfile.mkdtemp(), "config.yaml")
cfg.save(path)
assert load_yaml(open(path).read()) == cfg.to_dict()
assert get_dataset(cfg.dataset, "train")[1]["rgb"].shape == (24, 32, 3)
for mod in ("implicit_depth_torch.tools.make_disk_datasets",
            "implicit_depth_torch.tools.complete_depth"):
    importlib.import_module(mod)
loaded = {m for m in ("cv2", "PIL", "h5py") if sys.modules.get(m)}
assert not loaded, loaded
print("ok")
"""


def test_port_runs_without_opencv_pillow_or_yaml():
    import subprocess
    import sys
    out = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORTS], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), \
        out.stdout + out.stderr


@pytest.mark.parametrize("name", sorted(
    p.name for p in (REPO / "configs").glob("*.yaml")))
def test_yaml_reader_and_writer_equal_pyyaml(name, tmp_path):
    import yaml

    from implicit_depth_torch.config import load_yaml
    text = (REPO / "configs" / name).read_text()
    assert load_yaml(text) == yaml.safe_load(text)
    cfg = load_config(str(REPO / "configs" / name))
    cfg.save(str(tmp_path / "config.yaml"))
    dumped = (tmp_path / "config.yaml").read_text()
    assert yaml.safe_load(dumped) == cfg.to_dict() == load_yaml(dumped)
