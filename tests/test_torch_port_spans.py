"""The port's spans (``implicit_depth_torch/utils/profiling.py``) on the
CPU: off they cost one check and record nothing; on they record the tree
of a call or step (parents and roots, across threads) and annotate a
profile; ``idle_by_span`` splits a profile's idle; the trainer's
``[timing]`` line comes from them; and the benchmark's readers of them."""

import re
import sys
import threading
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from implicit_depth_torch.builder import build_lidf, build_refine, build_static
from implicit_depth_torch.config import load_config
from implicit_depth_torch.data.synthetic import synthetic_batch
from implicit_depth_torch.infer import DepthCompleter
from implicit_depth_torch.train.state import TrainState
from implicit_depth_torch.train.steps import (
    make_lidf_train_step,
    make_refine_train_step,
)
from implicit_depth_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

torch.set_num_threads(2)
H, W = 48, 64


def _new(since):
    """The records of the spans opened after record id ``since``."""
    return [r for r in profiling.spans() if r.id > since]


def _last_id():
    return max((r.id for r in profiling.spans()), default=0)


def _on():
    """Whether spans record now: off, every span is the one do-nothing
    context manager."""
    return profiling.span("t.probe") is not profiling.span("t.probe")


@pytest.fixture
def traced():
    """Tracing on for the test, off after it."""
    profiling.enable()
    yield
    profiling.disable()


# -- off --------------------------------------------------------------------

def test_a_span_off_reads_no_clock_and_enters_no_record_function(monkeypatch):
    assert not _on()
    reads = []
    clocks = {fn: (lambda real=getattr(time, fn): reads.append(1) or real())
              for fn in ("perf_counter", "perf_counter_ns", "time_ns")}
    monkeypatch.setattr(profiling, "time", types.SimpleNamespace(**clocks))

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)

    @profiling.spanned("t.decorated")
    def work(x):
        return x + 1

    since, totals = _last_id(), profiling.span_totals()
    with profiling.span("t.off"):
        with profiling.span("t.off.inner", adopt=True):
            assert work(1) == 2
    assert profiling.span("t.a") is profiling.span("t.b")  # nothing made
    assert reads == [] and _new(since) == []
    assert profiling.span_totals() == totals


# -- on -----------------------------------------------------------------------

def test_spans_annotate_a_profile_with_parents_and_roots_across_threads():
    """Under ``torch.profiler.profile`` (no enable()): the spans of the
    profiled thread are the profile's user annotations by name, at the
    records' place on its timeline; a span opened on another thread while an ``adopt`` span is
    open takes it as parent and its root, one opened with none open is a
    root of its own."""
    since = _last_id()
    seen = {}

    def on_thread(name):
        with profiling.span(name):
            seen[name] = torch.ones(4).sum()

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert _on()
        th = threading.Thread(target=on_thread, args=("t.alone",))
        th.start()
        th.join(timeout=60)
        assert not th.is_alive()
        with profiling.span("t.root"):
            with profiling.span("t.backward", adopt=True):
                th = threading.Thread(target=on_thread, args=("t.thread",))
                th.start()
                th.join(timeout=60)
                assert not th.is_alive()
            with profiling.span("t.child"):
                torch.ones(8).relu()
    assert not _on()
    assert set(seen) == {"t.alone", "t.thread"}
    recs = {r.name: r for r in _new(since)}
    assert set(recs) == {"t.alone", "t.root", "t.backward", "t.thread",
                         "t.child"}
    root, bwd = recs["t.root"], recs["t.backward"]
    assert root.parent is None and root.root == root.id
    assert recs["t.alone"].parent is None
    assert recs["t.alone"].root == recs["t.alone"].id
    assert bwd.parent == root.id and bwd.root == root.id
    assert recs["t.thread"].parent == bwd.id
    assert recs["t.thread"].root == root.id
    assert recs["t.child"].parent == root.id
    assert recs["t.child"].root == root.id
    assert root.start_ns <= bwd.start_ns <= bwd.end_ns <= root.end_ns
    # the profiler follows the autograd engine's threads, not a thread of
    # Python's own: those two spans are recorded, not annotated
    events = {ev.name: ev for ev in prof.events()
              if getattr(ev, "is_user_annotation", False)}
    on_main = {"t.root", "t.backward", "t.child"}
    assert on_main <= set(events)
    start = prof.profiler.kineto_results.trace_start_ns()
    off = profiling.clock_offset_ns()
    for name in on_main:
        r = recs[name]
        on_trace_us = (r.start_ns + off - start) / 1e3
        assert abs(on_trace_us - events[name].time_range.start) < 5e3, name
    totals = profiling.span_totals()
    assert totals["t.root"][0] >= 1 and totals["t.root"][1] > 0


def test_enable_nests_and_disable_turns_it_off():
    profiling.enable()
    profiling.enable()
    profiling.disable()
    assert _on()
    since = _last_id()
    with profiling.span("t.enabled"):
        pass
    profiling.disable()
    assert not _on()
    with profiling.span("t.disabled"):
        pass
    assert [r.name for r in _new(since)] == ["t.enabled"]


def test_the_ring_keeps_the_last_records(traced, monkeypatch):
    ring = profiling.collections.deque(profiling.spans(), maxlen=3)
    monkeypatch.setattr(profiling, "_records", ring)
    for i in range(5):
        with profiling.span(f"t.ring{i}"):
            pass
    assert [r.name for r in profiling.spans()] == ["t.ring2", "t.ring3",
                                                   "t.ring4"]


# -- idle_by_span -------------------------------------------------------------

def _event(start, end, name="op", device="DeviceType.CUDA", annotation=False):
    return types.SimpleNamespace(
        time_range=types.SimpleNamespace(start=start, end=end), name=name,
        device_type=device, is_user_annotation=annotation)


def test_idle_by_span_puts_each_gap_in_the_innermost_span():
    """Gaps (us): [0, 10] in a; [30, 50] in b (inside a, opened later);
    [60, 150] with its midpoint past a: outside; [160, 200] outside. A
    span's mirror on the device's timeline is no device operation."""
    host = "DeviceType.CPU"
    events = [_event(0, 100, "a", host, True), _event(20, 70, "b", host, True),
              _event(40, 45, "b", annotation=True),
              _event(10, 20), _event(15, 30), _event(50, 60),
              _event(150, 160), _event(190, 200, "not_a_span", host, True)]
    prof = types.SimpleNamespace(events=lambda: events)
    profiling.enable()
    try:  # the registry's names: the program's spans
        with profiling.span("a"), profiling.span("b"):
            pass
    finally:
        profiling.disable()
    got = profiling.idle_by_span(prof)
    assert got == pytest.approx({"a": 10e-6, "b": 20e-6,
                                 profiling.OUTSIDE: 90e-6 + 40e-6})
    assert list(got)[0] == profiling.OUTSIDE
    share = profiling.device_idle_share(prof)
    assert sum(got.values()) == pytest.approx(share * 200e-6)


def test_idle_by_span_of_a_cpu_profile_sums_to_its_window(tmp_path):
    with profiling.trace(str(tmp_path), cuda=False) as t:
        with profiling.span("t.outer"):
            with profiling.span("t.inner"):
                torch.randn(64, 64).matmul(torch.randn(64, 64))
    events = t.profile.events()
    window = (max(ev.time_range.end for ev in events)
              - min(ev.time_range.start for ev in events)) / 1e6
    got = profiling.idle_by_span(t.profile)
    assert set(got) <= {"t.outer", "t.inner", profiling.OUTSIDE}
    assert sum(got.values()) == pytest.approx(
        profiling.device_idle_share(t.profile) * window)


# -- the program's span tree ----------------------------------------------------

def _cfg():
    return load_config(overrides={
        "mask_type": "all",
        "dataset": {"img_height": H, "img_width": W},
        "model": {"rgb_out": 8, "pnet_out": 16, "pnet_gf": 8, "imnet_gf": 8,
                  "resnet_stages": [1, 1, 1, 1]},
        "refine": {"pnet_out": 16, "pnet_gf": 8, "imnet_gf": 8},
        "grid": {"res": 8, "miss_sample_num": 256, "valid_sample_num": 256},
        "tpu": {"max_pairs_per_ray": 12, "pairs_budget_per_ray": 8,
                "compute_dtype": "float32"}})


def _driver_spans():
    from benchmark.harness import spec
    names = set()
    for d in ("serve", "train"):
        mod = spec.load_module(ROOT / "benchmark" / "drivers" / f"{d}.py",
                               f"spans_test_driver_{d}")
        names |= set(mod.SPANS)
    return names


def _tree(recs):
    """{parent name: sorted child names, sync.* spans left out}, after
    checking that every record shares the one root and every record but
    the root has a parent."""
    roots = [r for r in recs if r.parent is None]
    assert len(roots) == 1, [r.name for r in roots]
    root = roots[0]
    by_id = {r.id: r for r in recs}
    tree = {}
    for r in recs:
        assert r.root == root.id, r
        if r.parent is not None and not r.name.startswith("sync."):
            tree.setdefault(by_id[r.parent].name, set()).add(r.name)
    assert not (_driver_spans() & {r.name for r in recs})
    return root.name, {k: sorted(v) for k, v in tree.items()}


def _models(cfg, static):
    g = torch.Generator().manual_seed(0)
    return build_lidf(cfg, static, g), build_refine(cfg, static, g)


def test_a_served_call_is_one_span_tree(traced):
    cfg = _cfg()
    lidf, refine = _models(cfg, build_static(cfg, n_rays=H * W))
    dc = DepthCompleter(cfg, lidf=lidf, refine=refine, batch_size=2,
                        device="cpu")
    raw = synthetic_batch(3, 2, H, W)
    rgb = (np.random.default_rng(3).random((2, H, W, 3)) * 255).astype(
        np.uint8)
    since = _last_id()
    dc.complete_batch(list(rgb), list(raw["depth_corrupt"]),
                      [(80.0, 80.0, W / 2, H / 2)] * 2, seed=4)
    root, tree = _tree(_new(since))
    assert root == "infer.complete_batch"
    assert tree == {
        "infer.complete_batch": ["infer.device_batch", "infer.forward",
                                 "infer.read_back"],
        "infer.device_batch": ["infer.h2d", "infer.prep_frames"],
        "infer.forward": ["lidf.decode_rays", "lidf.prepare_inputs",
                          "lidf.trunk", "refine.forward"]}


STEP_CHILDREN = ["lidf.decode_rays", "lidf.prepare_inputs", "lidf.trunk",
                 "train.backward", "train.loss", "train.optimizer"]


@pytest.mark.parametrize("stage", ["lidf", "refine"])
def test_a_train_step_is_one_span_tree(traced, stage):
    """Stage 2's frozen stage 1 sits under the same ``train.step``."""
    cfg = _cfg()
    static = build_static(cfg)
    lidf, refine = _models(cfg, static)
    if stage == "lidf":
        model, step = lidf, make_lidf_train_step(cfg, lidf, "cpu")
    else:
        model, step = refine, make_refine_train_step(cfg, lidf, refine, "cpu")
    state = TrainState.create(model, cfg.training, steps_per_epoch=10)
    batch = {k: torch.from_numpy(v)
             for k, v in synthetic_batch(7, 2, H, W).items()}
    since = _last_id()
    step(state, batch, torch.Generator().manual_seed(1), 0)
    root, tree = _tree(_new(since))
    assert root == "train.step"
    want = STEP_CHILDREN + (["refine.forward"] if stage == "refine" else [])
    assert tree == {"train.step": sorted(want)}


# -- the trainer's [timing] line ---------------------------------------------

def _trainer_cfg(tmp_path):
    return load_config(overrides={
        "trainer_name": "lidf", "exp_type": "train",
        "base_log_dir": str(tmp_path / "logs"), "log_name": "tiny",
        "mask_type": "all", "seed": 0,
        "dataset": {"type": "synthetic", "synthetic_len": 4,
                    "img_width": W, "img_height": H},
        "model": {"rgb_out": 8, "pnet_out": 16, "pnet_gf": 8, "imnet_gf": 8,
                  "resnet_stages": [1, 1, 1, 1]},
        "grid": {"miss_sample_num": 256, "valid_sample_num": 256},
        "training": {"batch_size": 2, "valid_batch_size": 1, "nepochs": 1,
                     "num_workers": 1, "log_interval": 1, "do_valid": False},
        "tpu": {"max_pairs_per_ray": 8, "compute_dtype": "float32",
                "train_steps_per_call": 1}})


@pytest.mark.parametrize("timing", [True, False])
def test_the_trainer_prints_its_timing_line_from_the_spans(
        tmp_path, monkeypatch, capsys, timing):
    from implicit_depth_torch.train.trainer import LIDFTrainer
    if timing:
        monkeypatch.setenv("IDT_TIMING", "1")
    else:
        monkeypatch.delenv("IDT_TIMING", raising=False)
    trainer = LIDFTrainer(_trainer_cfg(tmp_path), device="cpu")
    capsys.readouterr()
    since = _last_id()
    trainer.train_epoch(0)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[timing]")]
    assert not _on()
    if not timing:
        assert lines == [] and _new(since) == []
        return
    assert len(lines) == 1
    m = re.fullmatch(r"\[timing\] rank 0 epoch 0 feed_wait=(\d+\.\d\d)s "
                     r"dispatch=(\d+\.\d\d)s harvest=(\d+\.\d\d)s", lines[0])
    assert m, lines[0]
    recs = _new(since)
    for k, got in zip(("feed_wait", "dispatch", "harvest"), m.groups()):
        secs = sum(r.end_ns - r.start_ns for r in recs
                   if r.name == "train." + k) / 1e9
        assert abs(float(got) - secs) <= 0.0051, k
    names = [r.name for r in recs]
    assert names.count("train.step") == names.count("train.dispatch") == 2
    assert names.count("train.to_device") == 2


# -- the benchmark's readers of the spans ----------------------------------------

def _reader(metric):
    from benchmark.harness import spec
    return spec.load_module(ROOT / "benchmark" / "metrics" / f"{metric}.py",
                            "spans_test_metric_" + metric.replace(".", "_"))


def _rec(name, start_ms, end_ms, id_, parent=None, root=None):
    return profiling.SpanRecord(name, int(start_ms * 1e6), int(end_ms * 1e6),
                                parent, root if root is not None else id_,
                                id_)


def _fake_run(iters=2):
    """The window's benchmark spans end at 1000 ms; set-up's profiled call
    and the window's (untraced) spans come before."""
    return types.SimpleNamespace(
        spans=[("step_call", 0.2, 0.9), ("read_back", 0.95, 1.0)],
        driver=types.SimpleNamespace(traced_iters=iters))


ONE_NAME = {"frame_prep_ms.serve": "infer.prep_frames",
            "geometry_ms.serve": "lidf.prepare_inputs",
            "geometry_ms.train": "lidf.prepare_inputs",
            "backward_ms.train": "train.backward"}


@pytest.mark.parametrize("metric", list(ONE_NAME))
def test_a_span_reader_gives_the_mean_of_the_traced_stretch(monkeypatch,
                                                            metric):
    name = ONE_NAME[metric]
    recs = [_rec(name, 100, 190, 1),            # set-up's profiled call
            _rec(name, 1010, 1013, 2, 9, 9),    # traced: 3 ms
            _rec("other.span", 1020, 1030, 3, 9, 9),
            _rec("sync.other", 1021, 1025, 10, 3, 9),  # not the layer's
            _rec("sync.x", 1041, 1042, 5, 4, 9),       # a wait: 1 ms
            _rec("sync.nested", 1041.2, 1041.5, 6, 5, 9),
            _rec("other.child", 1043, 1044, 7, 4, 9),
            _rec("sync.z", 1043, 1043.5, 8, 7, 9),     # a wait: 0.5 ms
            _rec(name, 1040, 1045.5, 4, 9, 9)]  # traced: 5.5 ms
    monkeypatch.setattr(profiling, "spans", lambda: recs)
    # the layer's own time: its waits are sync_wait_ms's
    assert _reader(metric).read(_fake_run(2)) == pytest.approx(
        (3 + 5.5 - 1 - 0.5) / 2)
    monkeypatch.setattr(profiling, "spans", lambda: recs[:1])
    assert _reader(metric).read(_fake_run(2)) is None


def test_sync_wait_serve_reader_counts_the_waits_in_the_forward(
        monkeypatch):
    """A wait in the geometry (1 ms) holding a nested wait and one in the
    RefineNet (4 ms) under the forward; the read-back and the host
    preparation's spans are no wait of the forward."""
    recs = [_rec("sync.cell_of", 1101, 1102, 5, 3, 1),
            _rec("sync.inner", 1101.2, 1101.5, 6, 5, 1),
            _rec("lidf.prepare_inputs", 1100, 1110, 3, 2, 1),
            _rec("sync.posenc_consts", 1120, 1124, 8, 7, 1),
            _rec("refine.forward", 1115, 1130, 7, 2, 1),
            _rec("infer.forward", 1099, 1131, 2, 1, 1),
            _rec("infer.read_back", 1131, 1140, 9, 1, 1),
            _rec("infer.complete_batch", 1090, 1141, 1)]
    monkeypatch.setattr(profiling, "spans", lambda: recs)
    reader = _reader("sync_wait_ms.serve")
    assert reader.read(_fake_run(1)) == pytest.approx(1 + 4)
    monkeypatch.setattr(profiling, "spans", lambda: recs[-2:])
    assert reader.read(_fake_run(1)) is None


def test_sync_wait_reader_counts_each_wait_in_a_step_once(monkeypatch):
    """Under two steps: a wait in the loss (2 ms) holding a nested wait,
    and one in the backward's thread (1 ms); outside any step a wait (the
    trainer's harvest) and a wait before the stretch are left out."""
    recs = [_rec("sync.x", 10, 20, 1),
            _rec("sync.inner", 1101, 1102, 11, 10, 3),
            _rec("sync.loss_gates", 1100, 1102, 10, 4, 3),
            _rec("train.loss", 1099, 1103, 4, 3, 3),
            _rec("sync.bwd", 1200, 1201, 13, 12, 3),
            _rec("train.backward", 1150, 1250, 12, 3, 3),
            _rec("train.step", 1050, 1300, 3),
            _rec("sync.harvest", 1300, 1350, 14),
            _rec("sync.loss_gates", 1400, 1403.5, 22, 21, 20),
            _rec("train.step", 1390, 1500, 21, 20, 20),
            _rec("train.dispatch", 1380, 1510, 20)]
    monkeypatch.setattr(profiling, "spans", lambda: recs)
    reader = _reader("sync_wait_ms.train")
    assert reader.read(_fake_run(2)) == pytest.approx((2 + 1 + 3.5) / 2)
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert reader.read(_fake_run(2)) is None


@pytest.mark.parametrize("metric", [*ONE_NAME, "sync_wait_ms.train",
                                    "sync_wait_ms.serve"])
def test_a_span_reader_gives_none_on_a_program_without_spans(monkeypatch,
                                                              metric):
    monkeypatch.delattr(profiling, "spans")
    assert _reader(metric).read(_fake_run()) is None
