"""The port's trainer, metrics and visual dumps on the CPU: the metrics and
the depth images against the JAX package's, the trainer's small rules
against the JAX trainer's, and tiny f32 runs of the port's trainers against
the port's own train step run by hand (an epoch, items of several steps, a
mid-epoch resume, stage 2 behind a frozen stage 1), each bit for bit."""

import copy
import csv
import os.path as osp

import cv2
import numpy as np
import pytest
import torch

from implicit_depth_torch.builder import build_lidf, build_static
from implicit_depth_torch.config import load_config
from implicit_depth_torch.data.datasets import get_dataset
from implicit_depth_torch.data.loader import DataLoader
from implicit_depth_torch.train import metrics
from implicit_depth_torch.train.state import TrainState
from implicit_depth_torch.train.steps import make_lidf_train_step
from implicit_depth_torch.train.trainer import (
    LIDFTrainer,
    RefineTrainer,
    auto_log_name,
    to_device,
)
from implicit_depth_tpu.config import load_config as jax_load_config
from implicit_depth_tpu.train import metrics as jax_metrics
from implicit_depth_tpu.train import trainer as jax_trainer

torch.set_num_threads(2)


def tiny_overrides(tmp_path, tag="run", **training):
    return {
        "trainer_name": "lidf", "exp_type": "train",
        "base_log_dir": str(tmp_path / f"logs_{tag}"), "log_name": "tiny",
        "mask_type": "all", "seed": 0,
        "dataset": {"type": "synthetic", "synthetic_len": 8,
                    "img_width": 64, "img_height": 48},
        "model": {"rgb_out": 8, "pnet_out": 16, "pnet_gf": 8, "imnet_gf": 8,
                  "resnet_stages": [1, 1, 1, 1]},
        "refine": {"pnet_out": 16, "pnet_gf": 8, "imnet_gf": 8},
        "grid": {"miss_sample_num": 256, "valid_sample_num": 256},
        "training": {"batch_size": 2, "valid_batch_size": 1, "nepochs": 1,
                     "num_workers": 2, "log_interval": 1, "do_valid": False,
                     **training},
        "tpu": {"max_pairs_per_ray": 8, "compute_dtype": "float32",
                "train_steps_per_call": 1},
    }


def tiny_cfg(tmp_path, tag="run", **training):
    return load_config(overrides=tiny_overrides(tmp_path, tag, **training))


def assert_modules_equal(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert set(sa) == set(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


# -- metrics ------------------------------------------------------------------

@pytest.mark.parametrize("hw", [(480, 640), (240, 320), (96, 128)])
@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_resize_nearest_equals_cv2(hw, dtype):
    img = (np.random.default_rng(hw[0]).random(hw) * 200).astype(dtype)
    want = cv2.resize(img, (metrics.EVAL_W, metrics.EVAL_H),
                      interpolation=cv2.INTER_NEAREST)
    got = metrics.resize_nearest(img, metrics.EVAL_W, metrics.EVAL_H)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def _metric_inputs(case, hw=(240, 320)):
    rng = np.random.default_rng(7)
    gt = rng.uniform(0.5, 2.0, hw).astype(np.float32)
    gt[rng.random(hw) < 0.1] = 0.0
    seg = (rng.random(hw) < 0.3).astype(np.float32)
    pred = gt + rng.normal(0, 0.05, hw).astype(np.float32)
    if case == "zeros":
        pred = np.zeros(hw, np.float32)
    elif case == "empty_mask":
        seg = np.zeros(hw, np.float32)
    elif case == "nan_gt":
        gt[:10] = np.nan
    return pred, gt, seg


@pytest.mark.parametrize("case", ["random", "zeros", "empty_mask", "nan_gt"])
@pytest.mark.parametrize("resize", [True, False])
def test_cleargrasp_metrics_equal_jax(case, resize):
    pred, gt, seg = _metric_inputs(case)
    got = metrics.cleargrasp_metrics(pred, gt, seg, resize=resize)
    want = jax_metrics.cleargrasp_metrics(pred, gt, seg, resize=resize)
    assert (got is None) == (want is None) == (case == "empty_mask")
    if want is not None:
        assert got == want


def test_meter_bank_equals_jax():
    a, b = metrics.MeterBank(), jax_metrics.MeterBank()
    for i, v in enumerate([0.5, 1.25, 3.0]):
        for bank in (a, b):
            bank.add({"x": v, "y": -v}, n=i + 1)
    assert a.means() == b.means()


@pytest.mark.parametrize("eval_rays", [True, False])
def test_depth_images_from_outputs_equals_jax(eval_rays):
    rng = np.random.default_rng(3)
    b, h, w = 2, 12, 16
    hw = h * w
    xyz = rng.random((b, hw, 3)).astype(np.float32)
    if eval_rays:  # every pixel a ray, some not slotted
        midx = np.tile(np.arange(hw, dtype=np.int32), (b, 1))
        slot = rng.random((b, hw)) < 0.6
    else:  # a window of rays, the unslotted ones repeating pixel 0
        r = 50
        midx = np.stack([rng.permutation(hw)[:r] for _ in range(b)]).astype(
            np.int32)
        slot = rng.random((b, r)) < 0.7
        midx[~slot] = 0
    pred = rng.random(midx.shape + (3,)).astype(np.float32)
    want = jax_metrics.depth_images_from_outputs(
        {"xyz_corrupt_flat": xyz, "miss_idx": midx, "miss_slot": slot},
        pred, h, w)
    got = metrics.depth_images_from_outputs(
        {"xyz_corrupt_flat": torch.from_numpy(xyz),
         "miss_idx": torch.from_numpy(midx),
         "miss_slot": torch.from_numpy(slot)}, torch.from_numpy(pred), h, w)
    np.testing.assert_array_equal(got, want)


# -- the trainer's rules against the JAX trainer's ------------------------------

@pytest.mark.parametrize("overrides", [
    {}, {"loss": {"hard_neg": True, "hard_neg_ratio": 0.1}},
    {"custom_postfix": "x1", "training": {"lr": 1e-4, "batch_size": 4}}])
@pytest.mark.parametrize("stage", ["lidf", "refine"])
def test_auto_log_name_equals_jax(overrides, stage):
    assert (auto_log_name(load_config(overrides=overrides), stage)
            == jax_trainer.auto_log_name(jax_load_config(overrides=overrides),
                                         stage))


@pytest.mark.parametrize("start,interval,do_valid", [
    (0, 1, True), (0, 3, True), (2, 3, True), (0, 3, False)])
def test_should_validate_equals_jax(start, interval, do_valid):
    ov = {"training": {"nepochs": 7, "valid_start_epo": start,
                       "valid_interval": interval, "do_valid": do_valid}}
    port, jax = LIDFTrainer.__new__(LIDFTrainer), \
        jax_trainer.LIDFTrainer.__new__(jax_trainer.LIDFTrainer)
    port.cfg, jax.cfg = load_config(overrides=ov), jax_load_config(overrides=ov)
    assert ([port._should_validate(e) for e in range(7)]
            == [jax._should_validate(e) for e in range(7)])


@pytest.mark.parametrize("limit,exits", [(0, False), (10000, False),
                                         (0.001, True)])
def test_recycle_guard_equals_jax(limit, exits):
    codes = []
    for mod, load in ((None, load_config), (jax_trainer, jax_load_config)):
        tr = (mod.LIDFTrainer if mod else LIDFTrainer).__new__(
            mod.LIDFTrainer if mod else LIDFTrainer)
        tr.cfg = load(overrides={"tpu": {"host_rss_exit_gb": limit}})
        try:
            tr._maybe_recycle(0)
            codes.append(None)
        except SystemExit as e:
            codes.append(e.code)
    assert codes[0] == codes[1] == (82 if exits else None)


# -- tiny runs, bit for bit ------------------------------------------------------

def test_lidf_epoch_equals_its_steps_by_hand(tmp_path):
    cfg = tiny_cfg(tmp_path)
    tr = LIDFTrainer(cfg, device="cpu")
    assert tr.steps_per_epoch == 4
    means = tr.train_epoch(0)
    # the same steps by hand: same initial weights, loader batches and draws
    static = build_static(cfg)
    model = build_lidf(cfg, static, torch.Generator().manual_seed(0))
    state = TrainState.create(model, cfg.training, 4)
    step = make_lidf_train_step(cfg, model, "cpu")
    gen = torch.Generator().manual_seed(0)
    loader = DataLoader(get_dataset(cfg.dataset, "train", base_seed=0), 2,
                        shuffle=True, seed=0, num_workers=2)
    losses = [step(state, to_device(b, torch.device("cpu")), gen, 0)
              for b in loader.epoch(0)]
    assert len(losses) == 4 and state.step == tr.state.step == 4
    assert_modules_equal(tr.model, model)
    for k, v in means.items():
        if k != "epoch_time_s":
            assert v == np.mean([float(d[k]) for d in losses]), k


def test_steps_per_call_gives_the_same_bits(tmp_path):
    runs = []
    for k in (1, 4):
        cfg = tiny_cfg(tmp_path, f"k{k}")
        cfg.dataset.synthetic_len = 16
        cfg.tpu.train_steps_per_call = k
        tr = LIDFTrainer(cfg, device="cpu")
        assert tr._train_steps_per_call() == k
        runs.append((tr, tr.train_epoch(0)))
    (a, ma), (b, mb) = runs
    assert a.state.step == b.state.step == 8
    assert_modules_equal(a.model, b.model)
    assert {k: v for k, v in ma.items() if k != "epoch_time_s"} == \
        {k: v for k, v in mb.items() if k != "epoch_time_s"}


class _Preempted(RuntimeError):
    pass


@pytest.mark.parametrize("steps_per_call", [1, 2])
def test_mid_epoch_resume_is_bit_for_bit(tmp_path, steps_per_call):
    """The port's tests/test_preempt_resume.py: killed after 2 steps, the
    resumed run ends in the bits of the uninterrupted one."""
    def cfg_for(tag):
        cfg = tiny_cfg(tmp_path, tag, ckpt_every_steps=2)
        cfg.tpu.train_steps_per_call = steps_per_call
        return cfg

    tr_a = LIDFTrainer(cfg_for("a"), device="cpu")
    tr_a.run()

    tr_b = LIDFTrainer(cfg_for("b"), device="cpu")
    real_step, calls = tr_b.train_step, {"n": 0}

    def dying_step(*a, **k):
        if calls["n"] >= 2:
            raise _Preempted("simulated preemption")
        calls["n"] += 1
        return real_step(*a, **k)

    tr_b.train_step = dying_step
    with pytest.raises(_Preempted):
        tr_b.run()
    assert calls["n"] == 2

    cfg2 = cfg_for("b")
    cfg2.resume = "latest_network"
    tr_b2 = LIDFTrainer(cfg2, device="cpu")
    assert tr_b2.start_epoch == 0
    assert tr_b2._resume_skip_steps == 2
    assert tr_b2.state.step == 2
    tr_b2.run()
    assert tr_b2.state.step == 4
    assert_modules_equal(tr_a.model, tr_b2.model)
    assert tr_a.generator.get_state().equal(tr_b2.generator.get_state())

    cfg3 = cfg_for("b")
    cfg3.resume = "latest_network"
    tr_b3 = LIDFTrainer(cfg3, device="cpu")
    assert tr_b3.start_epoch == 1
    assert tr_b3._resume_skip_steps == 0


def test_refine_epoch_keeps_stage1_and_writes_the_test_csv(tmp_path):
    lidf = LIDFTrainer(tiny_cfg(tmp_path, "lidf"), device="cpu")
    lidf.run()
    cfg = tiny_cfg(tmp_path, "refine", do_valid=True)
    cfg.trainer_name = "refine"
    cfg.lidf_ckpt_path = lidf.ckpt_dir
    tr = RefineTrainer(cfg, device="cpu")
    assert_modules_equal(tr.lidf_model, lidf.model)
    before = copy.deepcopy(tr.refine_model)
    tr.run()
    assert_modules_equal(tr.lidf_model, lidf.model)
    moved = [n for (n, p), q in zip(tr.refine_model.named_parameters(),
                                    before.parameters()) if not torch.equal(p, q)]
    assert moved
    assert osp.exists(tr.valid_log_path)
    assert (tr.ckpt.latest_exists()
            and osp.isdir(osp.join(tr.ckpt_dir, "best_network")))

    # the test CSV: JAX's header, one row per image, the column means
    tr.test()
    with open(osp.join(tr.result_dir, "synthetic.csv")) as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["Image Num", "RMSE", "REL", "MAE", "Delta 1.05",
                       "Delta 1.10", "Delta 1.25"]
    assert rows[-1][0] == "MEAN" and len(rows) == 2 + 8
    body = np.asarray([r[1:] for r in rows[1:-1]], np.float64)
    np.testing.assert_array_equal(np.asarray(rows[-1][1:], np.float64),
                                  body.mean(0))


def test_lidf_test_csv_equals_the_metrics_of_its_outputs(tmp_path):
    cfg = tiny_cfg(tmp_path, "csv")
    cfg.exp_type = "test"
    tr = LIDFTrainer(cfg, device="cpu")
    tr.test()
    with open(osp.join(tr.result_dir, "synthetic.csv")) as f:
        rows = list(csv.reader(f))
    # recompute each row with JAX's metrics on the eval outputs of a fresh
    # trainer of the same seed (its generator draws the same valid points)
    again = LIDFTrainer(cfg, device="cpu")
    want = []
    for batch in again.make_valid_loaders()["synthetic"].epoch(0):
        inputs, pred, _ = again._eval(to_device(batch, again.device))
        depth = metrics.depth_images_from_outputs(inputs, pred, 48, 64)
        for i, path in enumerate(batch["item_path"]):
            m = jax_metrics.cleargrasp_metrics(depth[i], batch["depth"][i],
                                               batch["corrupt_mask"][i])
            if m:
                want.append([path, m["rmse"], m["abs_rel"], m["mae"], m["a1"],
                             m["a2"], m["a3"]])
    assert [r[0] for r in rows[1:-1]] == [r[0] for r in want]
    np.testing.assert_array_equal(
        np.asarray([r[1:] for r in rows[1:-1]], np.float64),
        np.asarray([r[1:] for r in want], np.float64))


def test_visual_dump_equals_jax(tmp_path):
    """The port's PNG writer and PLY dump give the pixels and points the
    JAX package's cv2-written dump gives."""
    from implicit_depth_torch.train.visualize import dump_batch_visuals
    from implicit_depth_tpu.data.synthetic import synthetic_batch
    from implicit_depth_tpu.train.visualize import (
        dump_batch_visuals as jax_dump,
    )
    from implicit_depth_tpu.utils.ply import load_point_cloud
    batch = synthetic_batch(2, 1, 24, 32)
    rng = np.random.default_rng(0)
    hw = 24 * 32
    inputs = {"miss_idx": np.arange(hw, dtype=np.int32)[None],
              "miss_slot": rng.random((1, hw)) < 0.5}
    pred = rng.random((1, hw, 3)).astype(np.float32)
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    dump_batch_visuals(str(tmp_path / "p"), "x", batch,
                       {k: torch.from_numpy(v) for k, v in inputs.items()},
                       torch.from_numpy(pred))
    jax_dump(str(tmp_path / "j"), "x", batch, inputs, pred)
    for name in ("panel", "gt_normal", "pred_normal"):
        got = cv2.imread(str(tmp_path / "p" / f"x_{name}.png"))
        want = cv2.imread(str(tmp_path / "j" / f"x_{name}.png"))
        np.testing.assert_array_equal(got, want, err_msg=name)
    for name in ("inp", "gt", "pred", "pred_transparent"):
        got = load_point_cloud(str(tmp_path / "p" / f"x_{name}.ply"))
        want = load_point_cloud(str(tmp_path / "j" / f"x_{name}.ply"))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w, err_msg=name)


def test_trainer_without_a_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LIDFTrainer(tiny_cfg(tmp_path))
