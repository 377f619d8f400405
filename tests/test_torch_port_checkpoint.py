"""The port's checkpoints (``implicit_depth_torch/train/checkpoint.py``) on
the CPU: the cases of ``tests/test_checkpoint.py`` on torch files (round
trip, params-only restore of a reshaped checkpoint, the tolerant fallback,
``merge_compatible``'s mismatches, the crash-safe swap), a resumed stage-2
training run bit for bit against an uninterrupted one, and
``DepthCompleter.from_checkpoint`` against the in-memory models."""

import json
import os

import numpy as np
import pytest
import torch
from torch import nn

from implicit_depth_torch.builder import (
    build_lidf,
    build_refine,
    build_static,
    randomize_weights_,
)
from implicit_depth_torch.config import load_config
from implicit_depth_torch.data.synthetic import synthetic_batch
from implicit_depth_torch.infer import DepthCompleter
from implicit_depth_torch.train.checkpoint import (
    LATEST,
    Checkpointer,
    merge_compatible,
    restore_params_only,
)
from implicit_depth_torch.train.state import TrainState
from implicit_depth_torch.train.steps import make_refine_train_step

torch.set_num_threads(2)
H, W = 48, 64


class Tiny(nn.Module):
    """Parameters ``a`` and ``b.w`` and a statistics buffer ``bn``, the
    shapes of the JAX test's state."""

    def __init__(self, a=(3, 4), w=(2,), fill=1.0, new=None):
        super().__init__()
        self.a = nn.Parameter(torch.full(a, fill))
        self.b = nn.Module()
        self.b.w = nn.Parameter(torch.full(w, 0.0 if fill == 1.0 else fill))
        self.register_buffer("bn", torch.ones(4))
        if new is not None:
            self.new = nn.Parameter(torch.full(new, fill))


def _state(model=None):
    model = model if model is not None else Tiny()
    return TrainState.create(model, load_config().training, steps_per_epoch=10)


def _adam_step(state):
    for p in state.model.parameters():
        p.grad = torch.ones_like(p)
    state.apply_gradients()


def test_save_restore_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path))
    state = _state()
    _adam_step(state)
    with torch.no_grad():
        state.model.a.fill_(2.5)
        state.model.bn.fill_(3.0)
    ck.save(state, epoch=3, meta={"best": 0.5}, snapshot=True)
    assert ck.latest_exists()
    assert ck.list_snapshots() == [3]

    restored, meta = ck.restore(_state())
    assert meta["epoch"] == 3 and meta["best"] == 0.5
    assert restored.step == 1
    np.testing.assert_array_equal(restored.model.a.detach().numpy(), 2.5)
    np.testing.assert_array_equal(restored.model.bn.numpy(), 3.0)
    # the optimizer state survives a strict restore
    want = state.optimizer.state_dict()["state"]
    got = restored.optimizer.state_dict()["state"]
    assert set(got) == set(want)
    for i in want:
        for k in want[i]:
            np.testing.assert_array_equal(np.asarray(got[i][k]),
                                          np.asarray(want[i][k]), err_msg=k)

    m = restore_params_only(str(tmp_path), Tiny(fill=7.0))
    np.testing.assert_array_equal(m.a.detach().numpy(), 2.5)
    np.testing.assert_array_equal(m.bn.numpy(), 3.0)

    # a named checkpoint (the stage-2 `lidf_ckpt_name: best_network` path)
    with torch.no_grad():
        state.model.a.fill_(7.0)
    ck.save_as(state, epoch=2, name="best_network", meta={"best": 0.1})
    m = restore_params_only(str(tmp_path), Tiny(), name="best_network")
    np.testing.assert_array_equal(m.a.detach().numpy(), 7.0)
    # the metadata rides in the JSON sidecar, not in the torch file
    with open(os.path.join(str(tmp_path), "best_network.meta.json")) as f:
        assert json.load(f) == {"best": 0.1, "epoch": 2}


def test_restore_params_only_tolerates_reshaped_ckpt(tmp_path, capsys):
    """A checkpoint whose shapes drifted loads in part: matching tensors are
    taken, mismatched and missing ones keep the model's."""
    ck = Checkpointer(str(tmp_path))
    ck.save(_state(), epoch=0)
    m = restore_params_only(str(tmp_path),
                            Tiny(w=(9,), fill=7.0, new=(2, 2)))
    np.testing.assert_array_equal(m.a.detach().numpy(), 1.0)     # taken
    np.testing.assert_array_equal(m.b.w.detach().numpy(), 7.0)   # reshaped
    np.testing.assert_array_equal(m.new.detach().numpy(), 7.0)   # missing
    np.testing.assert_array_equal(m.bn.numpy(), 1.0)
    out = capsys.readouterr().out
    assert "shape mismatch at 'model/b.w'" in out
    assert "missing model/new" in out


def test_restore_falls_back_to_tolerant_merge(tmp_path, capsys):
    """Checkpointer.restore of a drifted state does not fail: the strict
    load is refused, the tolerant merge takes what fits, and the optimizer
    state is reinitialized for the new parameters."""
    ck = Checkpointer(str(tmp_path))
    saved = _state()
    _adam_step(saved)
    ck.save(saved, epoch=2)

    template = _state(Tiny(w=(6,), fill=5.0, new=(2,)))
    with torch.no_grad():
        template.model.bn.zero_()
    restored, meta = ck.restore(template)
    assert meta["epoch"] == 2
    assert "falling back to shape-tolerant merge" in capsys.readouterr().out
    m = restored.model
    np.testing.assert_array_equal(m.a.detach().numpy(),
                                  saved.model.a.detach().numpy())  # taken
    np.testing.assert_array_equal(m.b.w.detach().numpy(), 5.0)       # kept
    np.testing.assert_array_equal(m.new.detach().numpy(), 5.0)       # kept
    np.testing.assert_array_equal(m.bn.numpy(), 1.0)
    # a fresh optimizer state over the template's parameters
    assert len(restored.optimizer.state) == 0
    assert len(restored.optimizer.param_groups[0]["params"]) == 3
    assert restored.step == 1


def test_merge_compatible_tolerates_mismatches():
    target = {"a": torch.zeros((3, 4)), "b": {"w": torch.zeros((2,)),
                                              "new": torch.zeros((5,))}}
    loaded = {"a": torch.ones((3, 4), dtype=torch.float64),
              "b": {"w": torch.ones((7,))}}                   # w mismatched
    out = merge_compatible(target, loaded)
    np.testing.assert_array_equal(out["a"].numpy(), 1.0)      # taken
    assert out["a"].dtype == torch.float32                    # target's dtype
    np.testing.assert_array_equal(out["b"]["w"].numpy(), 0.0)    # kept
    np.testing.assert_array_equal(out["b"]["new"].numpy(), 0.0)  # kept
    kept = merge_compatible({"b": {"w": torch.zeros(2)}}, {"b": torch.ones(2)})
    np.testing.assert_array_equal(kept["b"]["w"].numpy(), 0.0)  # not a subtree


def test_crash_safe_overwrite_keeps_a_snapshot(tmp_path):
    """A kill between the two renames of a save leaves ``.prev`` (the
    previous complete checkpoint), which latest_exists() and restore() fall
    back to; the next save heals the layout."""
    ck = Checkpointer(str(tmp_path))
    ck.save(_state(), 0, meta={"tag": 1})
    state_b = _state(Tiny(fill=2.0))
    ck.save(state_b, 1, meta={"tag": 2})

    base = os.path.join(str(tmp_path), LATEST)
    os.rename(base, base + ".prev")
    os.replace(base + ".meta.json", base + ".prev.meta.json")
    assert ck.latest_exists()
    restored, meta = ck.restore(_state())
    assert restored.model.a[0, 0].item() == 2.0
    assert meta["tag"] == 2

    # a killed save's leftovers under .next are cleared by the next save
    os.makedirs(base + ".next")
    ck.save(_state(), 2, meta={"tag": 3})
    assert os.path.isdir(base)
    assert not os.path.exists(base + ".prev")
    assert not os.path.exists(base + ".next")
    _, meta = ck.restore(_state())
    assert meta["tag"] == 3


# -- stage 2 resumed from a checkpoint, and served from one -------------------

def _tiny_cfg(**extra):
    return load_config(overrides={
        "mask_type": "all",
        "dataset": {"img_height": H, "img_width": W},
        "model": {"rgb_out": 8, "pnet_out": 16, "pnet_gf": 8, "imnet_gf": 8,
                  "resnet_stages": [1, 1, 1, 1]},
        "refine": {"pnet_out": 16, "pnet_gf": 8, "imnet_gf": 8},
        "grid": {"res": 8, "miss_sample_num": 256, "valid_sample_num": 512},
        "tpu": {"max_pairs_per_ray": 12, "pairs_budget_per_ray": 8,
                "compute_dtype": "float32"}, **extra})


def _pair(cfg, static, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (randomize_weights_(build_lidf(cfg, static, g), g),
            randomize_weights_(build_refine(cfg, static, g), g))


def test_stage2_resume_is_bit_identical(tmp_path):
    """Stage 2 from a saved stage 1: N steps straight against N - k steps,
    a checkpoint, a restore into fresh models, then k steps; every step's
    draws from a generator seeded by its index. Parameters, optimizer state
    and losses equal bit for bit."""
    cfg = _tiny_cfg()
    static = build_static(cfg)
    lidf0, refine0 = _pair(cfg, static)
    Checkpointer(str(tmp_path / "lidf")).save(lidf0, epoch=0)
    batches = [{k: torch.from_numpy(v) for k, v in
                synthetic_batch(50 + i, 2, H, W).items()} for i in range(3)]
    n, k = 3, 1

    def fresh_run():
        lm = restore_params_only(str(tmp_path / "lidf"),
                                 build_lidf(cfg, static))
        rm = build_refine(cfg, static)
        rm.load_state_dict(refine0.state_dict())
        state = TrainState.create(rm, cfg.training, steps_per_epoch=2)
        return state, make_refine_train_step(cfg, lm, rm, "cpu")

    def run(state, step, steps):
        out = []
        for i in steps:
            losses = step(state, batches[i], torch.Generator().manual_seed(i),
                          epoch=i // 2)
            out.append({key: v.item() for key, v in losses.items()})
        return out

    state_a, step_a = fresh_run()
    losses_a = run(state_a, step_a, range(n))

    state_b, step_b = fresh_run()
    run(state_b, step_b, range(n - k))
    ck = Checkpointer(str(tmp_path / "refine"))
    ck.save(state_b, epoch=0, meta={"step": n - k})
    state_c, step_c = fresh_run()
    state_c, meta = ck.restore(state_c)
    assert state_c.step == n - k == meta["step"]
    losses_c = run(state_c, step_c, range(n - k, n))

    assert losses_c == losses_a[n - k:]
    assert state_c.step == state_a.step == n
    for (name, pa), pc in zip(state_a.model.named_parameters(),
                              state_c.model.parameters()):
        np.testing.assert_array_equal(pa.detach().numpy(),
                                      pc.detach().numpy(), err_msg=name)
    sa, sc = (s.optimizer.state_dict()["state"] for s in (state_a, state_c))
    for i in sa:
        for key in sa[i]:
            np.testing.assert_array_equal(np.asarray(sa[i][key]),
                                          np.asarray(sc[i][key]))


def test_from_checkpoint_serves_the_saved_pair(tmp_path):
    """``DepthCompleter.from_checkpoint`` of a saved stage 1 and stage 2
    serves a frame bit for bit as the in-memory pair; ``best_network``
    falls back to ``latest_network``; without the stage-2 directory it
    serves stage 1 alone."""
    cfg = _tiny_cfg()
    static = build_static(cfg, n_rays=H * W)
    lidf0, refine0 = _pair(cfg, static, seed=3)
    Checkpointer(str(tmp_path / "lidf")).save(lidf0, epoch=0)
    Checkpointer(str(tmp_path / "refine")).save_as(
        _state(refine0), epoch=4, name="best_network")
    raw = synthetic_batch(8, 1, H, W)
    rgb = np.random.default_rng(9).integers(0, 255, (H, W, 3), dtype=np.uint8)
    frame = (rgb, raw["depth_corrupt"][0], (80.0, 80.0, W / 2, H / 2))

    want = DepthCompleter(cfg, lidf=lidf0, refine=refine0,
                          device="cpu").complete(*frame)
    dc = DepthCompleter.from_checkpoint(str(tmp_path / "lidf"),
                                        str(tmp_path / "refine"), cfg=cfg,
                                        device="cpu")
    got = dc.complete(*frame)
    for key in ("depth", "depth_pred"):
        assert got[key].tobytes() == want[key].tobytes(), key
    one = DepthCompleter.from_checkpoint(str(tmp_path / "lidf"), cfg=cfg,
                                         device="cpu")
    assert one.refine is None
    stage1 = DepthCompleter(cfg, lidf=lidf0, device="cpu").complete(*frame)
    assert one.complete(*frame)["depth_pred"].tobytes() == \
        stage1["depth_pred"].tobytes()


def test_checkpoint_holds_only_tensors_and_numbers(tmp_path):
    """The torch file loads with ``weights_only=True`` (no pickled objects):
    the metadata lives in the sidecar."""
    ck = Checkpointer(str(tmp_path))
    state = _state()
    _adam_step(state)
    ck.save(state, epoch=1, meta={"note": "x"})
    tree = torch.load(os.path.join(str(tmp_path), LATEST, "state.pt"),
                      weights_only=True)
    assert set(tree) == {"model", "optimizer", "step"}
    assert tree["step"] == 1
    assert all(t.device.type == "cpu" for t in tree["model"].values())


@pytest.mark.parametrize("bad", ["not a state", 3])
def test_save_refuses_what_is_not_a_state(tmp_path, bad):
    with pytest.raises(TypeError):
        Checkpointer(str(tmp_path)).save(bad, epoch=0)
