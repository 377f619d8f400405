"""The port's profiling module (``implicit_depth_torch/utils/profiling.py``)
against the JAX package's (``implicit_depth_tpu/utils/profiling.py``) on
the CPU: the slope core on fake clocks, the stage registry, the one
read-back a run of ``device_slope_time``, and ``trace``'s Chrome trace."""

import json
import types

import pytest
import torch

from implicit_depth_torch.utils import profiling as port
from implicit_depth_tpu.utils import profiling as jax_prof

torch.set_num_threads(2)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _fake_clock(monkeypatch):
    """One clock for both modules: they read ``time.perf_counter`` through
    the same ``time`` module."""
    clock = FakeClock()
    monkeypatch.setattr(port.time, "perf_counter", clock.perf_counter)
    assert jax_prof.time.perf_counter == clock.perf_counter
    return clock


def _normal(clock):
    mk = lambda iters: lambda: clock.advance(0.01 * iters)  # noqa: E731
    return mk(3), mk(13), 0.01


def _first_phase_inflation(clock):
    """The first measured A run is 20x slow: the median ignores it."""
    calls = {"a": 0}

    def run_a():
        calls["a"] += 1
        clock.advance(0.6 if calls["a"] == 3 else 0.03)
    return run_a, lambda: clock.advance(0.13), 0.01


def _retried(clock):
    """Every A run of the first attempt is slower than B (a non-positive
    slope); the retry's runs are not."""
    calls = {"a": 0}

    def run_a():
        calls["a"] += 1
        clock.advance(0.5 if 3 <= calls["a"] <= 5 else 0.03)
    return run_a, lambda: clock.advance(0.13), 0.01


def _fallback(clock):
    """A is always slower: the retry fails too, and the long loop's mean
    per iteration is returned."""
    return (lambda: clock.advance(0.5), lambda: clock.advance(0.13),
            0.13 / 13)


SLOPE_CASES = {"normal": _normal,
               "first-phase inflation": _first_phase_inflation,
               "non-positive slope retried": _retried,
               "non-positive slope, then the fallback": _fallback}


@pytest.mark.parametrize("case", list(SLOPE_CASES))
def test_interleaved_slope_equals_jax_on_fake_clocks(monkeypatch, capsys,
                                                     case):
    """The cases of ``test_bench_slope.py`` and a retry that succeeds: the
    port's slope is the JAX package's, value and messages."""
    got = {}
    for name, mod in (("jax", jax_prof), ("port", port)):
        clock = _fake_clock(monkeypatch)
        run_a, run_b, want = SLOPE_CASES[case](clock)
        got[name] = (mod.interleaved_slope(run_a, run_b, 3, 13, verbose=True),
                     capsys.readouterr().out)
    assert got["port"] == got["jax"]
    assert got["port"][0] == pytest.approx(want) and got["port"][0] > 0
    retried = "non-positive slope" in got["port"][1]
    assert retried == (case not in ("normal", "first-phase inflation"))
    assert ("conservative" in got["port"][1]) == case.endswith("fallback")


def test_stage_timer_accumulates_and_resets_as_jax(monkeypatch):
    def use(mod, clock):
        mod.stage_times()
        for name, dt in (("load", 0.5), ("step", 0.25), ("load", 0.125)):
            with mod.stage_timer(name, sync=name == "step"):
                clock.advance(dt)
        with pytest.raises(KeyError):  # a failing stage is still timed
            with mod.stage_timer("fail"):
                clock.advance(1.0)
                raise KeyError("x")
        kept = mod.stage_times(reset=False)
        return kept, mod.stage_times(), mod.stage_times()

    clock = _fake_clock(monkeypatch)
    want = use(jax_prof, clock)
    assert use(port, clock) == want
    assert want[0] == {"load": 0.625, "step": 0.25, "fail": 1.0}
    assert want[1] == want[0] and want[2] == {}


def test_stage_timer_syncs_the_device_it_is_given(monkeypatch):
    """``sync=True`` waits for the current CUDA device only where CUDA is in
    use; a device given is waited for when it is a card, not the CPU."""
    waited = []
    monkeypatch.setattr(port.torch.cuda, "synchronize",
                        lambda dev=None: waited.append(dev))
    monkeypatch.setattr(port.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(port.torch.cuda, "is_initialized", lambda: True)
    for sync in (False, "cpu", torch.device("cpu"), True, "cuda:1"):
        with port.stage_timer("s", sync=sync):
            pass
    assert waited == [None, torch.device("cuda:1")]
    port.stage_times()


def test_device_slope_time_reads_back_once_a_run(monkeypatch):
    """On the CPU with a fake clock: each call of ``fn`` costs 4 ms, so the
    slope is 4 ms; a run calls ``fn`` with generators seeded 0, 1, ...,
    and reads back one scalar, the sum of its calls' results."""
    clock = _fake_clock(monkeypatch)
    reads, seeds = [], []
    item = torch.Tensor.item

    def counted_item(t):
        reads.append(item(t))
        return reads[-1]
    monkeypatch.setattr(torch.Tensor, "item", counted_item)

    def fn(gen, x, scale):
        seeds.append(gen.initial_seed())
        assert gen.device == x.device
        clock.advance(0.004)
        return (x * scale).sum() + torch.rand((), generator=gen) * 0

    x = torch.ones(3)
    got = port.device_slope_time(fn, x, 2.0, iters_a=2, iters_b=7, reps=3)
    assert got == pytest.approx(0.004)
    runs = 2 * 2 + 2 * 3  # two untimed runs of each loop, then 3 pairs
    assert len(reads) == runs
    assert sorted(set(reads)) == [12.0, 42.0]  # 2 and 7 calls of 6.0
    per_run = [list(range(2)), list(range(2)), list(range(7)),
               list(range(7))] + [list(range(2)), list(range(7))] * 3
    assert seeds == [s for r in per_run for s in r]


def test_trace_writes_a_chrome_trace_of_the_cpu_ops(tmp_path):
    x = torch.randn(64, 64)
    with port.trace(str(tmp_path / "t"), cuda=False) as t:
        (x @ x).relu().sum()
    assert t.profile is not None and not t.cuda
    assert t.path.startswith(str(tmp_path / "t"))
    with open(t.path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"aten::mm", "aten::relu", "aten::sum"} <= names
    assert port.device_ops(t.profile) == {}  # nothing ran on a device
    assert port.device_idle_share(t.profile) == 1.0


def test_trace_refuses_cuda_activity_it_cannot_record(tmp_path, monkeypatch):
    monkeypatch.setattr(port.torch.cuda, "is_available", lambda: False)
    with port.trace(str(tmp_path)) as t:  # default: no card, CPU only
        torch.ones(2).sum()
    assert not t.cuda
    with pytest.raises(RuntimeError, match="CUDA activity"):
        with port.trace(str(tmp_path), cuda=True):
            pass


def _event(start, end, device="DeviceType.CUDA", annotation=False):
    return types.SimpleNamespace(
        time_range=types.SimpleNamespace(start=start, end=end),
        device_type=device, is_user_annotation=annotation)


def test_device_idle_share_is_the_window_without_device_operations():
    """Overlapping and nested device operations count once; a user
    annotation on the device's timeline and host events count none."""
    events = [_event(0, 100, "DeviceType.CPU"), _event(10, 20),
              _event(15, 30), _event(18, 22), _event(50, 60),
              _event(40, 90, annotation=True),
              _event(95, 120, "DeviceType.CPU")]
    prof = types.SimpleNamespace(events=lambda: events)
    assert port.device_idle_share(prof) == pytest.approx(1 - 30 / 120)


def _chip_smoke():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_symbols", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name,want", [
    ("void (anonymous namespace)::ray_decode_tc<0, 64, 0>((anonymous "
     "namespace)::Params<__nv_bfloat16>)", ("ray_decode_tc", 0)),
    ("_ZN12_GLOBAL__N_113ray_decode_tcILi1ELi64ELi0EEEvNS_6ParamsI13__nv_"
     "bfloat16EE", ("ray_decode_tc", 1)),
    ("void (anonymous namespace)::pass_a_kernel<__nv_bfloat16, 64, 0, 64>"
     "((anonymous namespace)::BwdParams<__nv_bfloat16>)",
     ("pass_a_kernel", None)),
    ("void (anonymous namespace)::reduce_kernel(float const*, float*, "
     "(anonymous namespace)::RedParams)", ("reduce_kernel", None)),
    ("_ZN12_GLOBAL__N_17to_bf16EPKfP13__nv_bfloat16x", ("to_bf16", None)),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, "
     "at::native::func_wrapper_t<float, at::native::sum_functor<float, "
     "float, float>::operator()>, unsigned int, float, 4> >(at::native::"
     "ReduceOp<float>)", None),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<float, "
     "unsigned int, 4, 64, 64>(float*)", None),
    ("Memset (Device)", None), ("Memcpy HtoD (Pinned -> Device)", None)])
def test_chip_smoke_finds_the_port_kernels_by_symbol(name, want):
    """Phase 43 counts a trace's kernels of the port (every source's
    kernels are in an anonymous namespace) by their demangled or mangled
    symbol, and no kernel of PyTorch's."""
    assert _chip_smoke().kernel_symbol(name) == want
