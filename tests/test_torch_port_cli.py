"""The port's CLI (``implicit_depth_torch/main.py``) against the JAX
package's: the same config from the same flags and ``--set`` overrides, the
same dispatch on ``exp_type``; and a tiny run through it on the CPU."""

import json
import os.path as osp

import pytest
import torch

import implicit_depth_torch.train.trainer as trainer_mod
import implicit_depth_tpu.train.trainer as jax_trainer_mod
from implicit_depth_torch.main import main
from implicit_depth_tpu.main import main as jax_main

torch.set_num_threads(2)
CONFIGS = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))), "configs")


def _fake(captured, key):
    class FakeTrainer:
        def __init__(self, cfg, **kw):
            self.cfg = cfg
            captured[key] = {"cfg": cfg, "kw": kw, "calls": []}

        def run(self):
            captured[key]["calls"].append("run")

        def test(self):
            captured[key]["calls"].append("test")

    return FakeTrainer


@pytest.fixture
def captured(monkeypatch):
    out = {}
    monkeypatch.setitem(trainer_mod.TRAINERS, "fake", _fake(out, "port"))
    monkeypatch.setitem(jax_trainer_mod.TRAINERS, "fake", _fake(out, "jax"))
    # the JAX launcher turns on its compile cache; keep it off here
    monkeypatch.setattr("implicit_depth_tpu.utils.cache.enable_persistent_cache",
                        lambda *a, **k: None)
    return out


ARGVS = [
    ["--set", "trainer_name=fake", "exp_type=train", "training.lr=0.0005",
     "grid.res=4", "debug=True", "tpu.compute_dtype=float32"],
    ["--cfg_paths", osp.join(CONFIGS, "train_lidf.yaml"),
     osp.join(CONFIGS, "smoke_synthetic.yaml"), "--set", "trainer_name=fake",
     "refine.offset_range=[-0.1, 0.3]", "dataset.type=synthetic",
     "log_name=a b", "seed=None", "training.lr=1e-4"],
    ["--default_cfg_path", osp.join(CONFIGS, "train_refine.yaml"),
     "--cfg_paths", osp.join(CONFIGS, "test_refine.yaml"), "--set",
     "trainer_name=fake", "exp_type=valid", "checkpoint_path=/x/y"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=["set", "overlays", "default"])
def test_main_parses_as_jax(captured, argv):
    main(argv + ["--device", "cpu"])
    jax_main(argv)
    port, jax = captured["port"], captured["jax"]
    assert port["cfg"].to_dict() == jax["cfg"].to_dict()
    assert port["calls"] == jax["calls"] == (
        ["test"] if port["cfg"].exp_type == "valid" else ["run"])
    assert port["kw"] == {"device": "cpu"}


def test_set_overrides_parse(captured):
    """The JAX package's tests/test_main_cli.py, first case."""
    trainer = main(ARGVS[0])
    cfg = captured["port"]["cfg"]
    assert captured["port"]["calls"] == ["run"]
    assert captured["port"]["kw"] == {"device": "cuda"}
    assert isinstance(trainer, trainer_mod.TRAINERS["fake"])
    assert cfg.training.lr == 0.0005
    assert cfg.grid.res == 4
    assert cfg.debug is True
    assert cfg.tpu.compute_dtype == "float32"


@pytest.mark.parametrize("exp_type", ["test", "valid"])
def test_eval_exp_types_dispatch_to_test(captured, exp_type):
    main(["--set", "trainer_name=fake", f"exp_type={exp_type}"])
    assert captured["port"]["calls"] == ["test"]


def test_unknown_exp_type_raises(captured):
    """The JAX package's tests/test_main_cli.py, second case."""
    with pytest.raises(ValueError):
        main(["--set", "trainer_name=fake", "exp_type=bogus"])


def test_cli_trains_then_tests_on_the_cpu(tmp_path):
    tiny = [f"base_log_dir={tmp_path}", "log_name=cli", "training.nepochs=1",
            "dataset.img_width=64", "dataset.img_height=48",
            "dataset.synthetic_len=4", "grid.miss_sample_num=256",
            "grid.valid_sample_num=256", "tpu.max_pairs_per_ray=8",
            "tpu.compute_dtype=float32", "model.rgb_out=8",
            "model.pnet_out=16", "model.pnet_gf=8", "model.imnet_gf=8",
            "model.resnet_stages=[1, 1, 1, 1]", "training.valid_batch_size=2"]
    base = ["--device", "cpu", "--cfg_paths",
            osp.join(CONFIGS, "smoke_synthetic.yaml"), "--set", *tiny]
    tr = main(base)
    assert isinstance(tr, trainer_mod.LIDFTrainer) and tr.state.step == 1
    with open(osp.join(tr.workdir, "epoch_log.jsonl")) as f:
        record = json.loads(f.read().splitlines()[-1])
    assert record["epoch"] == 0 and "valid" in record
    main(base + ["exp_type=test", "resume=latest_network"])
    with open(osp.join(tr.result_dir, "synthetic.csv")) as f:
        assert f.read().splitlines()[-1].startswith("MEAN,")
