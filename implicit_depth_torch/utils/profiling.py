"""Tracing and profiling of the port (the counterpart of
``implicit_depth_tpu/utils/profiling.py``).

- :func:`stage_timer` / :func:`stage_times`: wall-clock stage timing in one
  registry; ``sync`` waits for the device the stage ran on before the stage
  is closed (PyTorch returns before a card has finished).
- :func:`interleaved_slope`: seconds per iteration from two loops of
  ``iters_a`` and ``iters_b`` iterations, timed in interleaved pairs (the
  median pair difference), robust to a slow first measured run.
- :func:`device_slope_time`: seconds per call of a function that returns a
  device scalar, from runs of ``iters_a`` and ``iters_b`` calls launched
  back to back, each run read back once.
- :func:`trace`: a ``torch.profiler`` trace of a block (CPU, and the card's
  activity when the work is on one), written as a Chrome trace;
  :func:`device_ops` and :func:`device_idle_share` read what it recorded.

To profile a served frame or a train step on the card::

    from implicit_depth_torch.utils import profiling

    with profiling.trace("logs/trace") as t:
        dc.complete(rgb, depth, intrinsics)
    ops = profiling.device_ops(t.profile)    # {kernel: (device ms, count)}
    idle = profiling.device_idle_share(t.profile)
    # t.path: the Chrome trace (chrome://tracing, Perfetto)
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, Optional, Tuple, Union

import torch

_REGISTRY: Dict[str, float] = {}


def _synchronize(device: Union[bool, str, torch.device]) -> None:
    """Wait for ``device`` (True: the current CUDA device, where CUDA is
    in use); a CPU device has nothing in flight."""
    if device is True:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        return
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def stage_timer(name: str, sync: Union[bool, str, torch.device] = False):
    """Add the block's wall-clock seconds to ``name`` in the registry.
    ``sync``: the device the stage ran on (or True: the current CUDA
    device), waited for before the clock is read."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync is not False:
            _synchronize(sync)
        _REGISTRY[name] = _REGISTRY.get(name, 0.0) + time.perf_counter() - t0


def stage_times(reset: bool = True) -> Dict[str, float]:
    """{stage: seconds} accumulated since the last reset."""
    out = dict(_REGISTRY)
    if reset:
        _REGISTRY.clear()
    return out


def interleaved_slope(run_a: Callable[[], None], run_b: Callable[[], None],
                      iters_a: int, iters_b: int,
                      reps: int = 3, retries: int = 1,
                      verbose: bool = False) -> float:
    """Seconds per iteration from two zero-argument runnables: ``run_a``
    runs ``iters_a`` iterations and waits for them, ``run_b`` likewise.

    Each loop runs twice untimed (its first call builds and warms up),
    then A and B alternate for ``reps`` pairs and the median of the pair
    differences over ``iters_b - iters_a`` is the slope: a single pair is
    exposed to a slow first measured run. A non-positive median retries
    ``retries`` times, then falls back to the long loop's mean per
    iteration (which includes the per-run overhead: a conservative bound,
    never a negative time)."""
    for run in (run_a, run_b):
        run()  # first call
        run()  # throwaway warm run
    slope = None
    for attempt in range(retries + 1):
        diffs = []
        for _ in range(max(reps, 1)):
            t0 = time.perf_counter()
            run_a()
            ta = time.perf_counter() - t0
            t0 = time.perf_counter()
            run_b()
            tb = time.perf_counter() - t0
            diffs.append(tb - ta)
        diffs.sort()
        slope = diffs[len(diffs) // 2] / (iters_b - iters_a)
        if slope > 0:
            return slope
        if verbose and attempt < retries:
            print(f"# non-positive slope {slope:.6f}s/iter — retrying",
                  flush=True)
    t0 = time.perf_counter()
    run_b()
    fallback = (time.perf_counter() - t0) / iters_b
    if verbose:
        print(f"# slope stayed non-positive ({slope:.6f}); using "
              f"conservative per-iter mean {fallback:.6f}s", flush=True)
    return fallback


def _device_of(args) -> torch.device:
    """The device of the first tensor among ``args`` (or among the values
    of a dict argument); the CPU where there is none."""
    for a in args:
        for t in (a.values() if isinstance(a, dict) else (a,)):
            if torch.is_tensor(t):
                return t.device
    return torch.device("cpu")


def device_slope_time(fn: Callable[..., torch.Tensor], *args,
                      iters_a: int = 2, iters_b: int = 12,
                      reps: int = 3) -> float:
    """Seconds per call of ``fn(gen, *args)``, which returns a scalar
    tensor, by :func:`interleaved_slope` over runs of ``iters_a`` and
    ``iters_b`` calls.

    A run launches its calls back to back on the stream, call ``i`` with
    ``gen`` a ``torch.Generator`` on the arguments' device seeded with
    ``i`` (its per-call draws), adds their results into one f32 scalar on
    the device, and reads that scalar back once: the host never waits
    inside a run, so the slope is the device's time per call wherever the
    device is the slower side."""
    dev = _device_of(args)

    def make(iters):
        def run():
            acc = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(iters):
                gen = torch.Generator(device=dev).manual_seed(i)
                acc += fn(gen, *args).to(torch.float32)
            acc.item()  # the run's one read-back
        return run

    return interleaved_slope(make(iters_a), make(iters_b), iters_a, iters_b,
                             reps=reps)


class Trace:
    """What :func:`trace` recorded, filled in when its block ends:
    ``profile`` (the ``torch.profiler.profile``), ``path`` (the Chrome
    trace file), ``cuda`` (whether the card's activity was recorded)."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.profile = None
        self.path: Optional[str] = None


@contextlib.contextmanager
def trace(log_dir: str, cuda: Optional[bool] = None):
    """A ``torch.profiler`` trace of the block, written as a Chrome trace
    into ``log_dir``; yields a :class:`Trace`.

    ``cuda`` (default: whether a card is available) records the card's
    activity too, and the block's work is waited for before the trace
    stops. Raises where the card's activity is asked for and the profiler
    cannot record it, and where the trace comes back without an event (or,
    with ``cuda``, without a device event): a profile never comes back
    empty without saying so."""
    from torch.profiler import ProfilerActivity, profile, supported_activities
    if cuda is None:
        cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        if (not torch.cuda.is_available()
                or ProfilerActivity.CUDA not in supported_activities()):
            raise RuntimeError("trace: CUDA activity asked for, but this "
                               "torch.profiler cannot record it")
        activities.append(ProfilerActivity.CUDA)
    out = Trace(cuda)
    with profile(activities=activities) as prof:
        yield out
        if cuda:
            torch.cuda.synchronize()
    out.profile = prof
    events = prof.events()
    if not events:
        raise RuntimeError("trace: the profiler recorded no event")
    if cuda and not any(_on_device(ev) for ev in events):
        raise RuntimeError("trace: CUDA activity asked for, but the profiler "
                           "recorded no device operation")
    os.makedirs(log_dir, exist_ok=True)
    out.path = os.path.join(log_dir,
                            f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(out.path)


def _on_device(ev) -> bool:
    """Whether a profiler event is a device operation (a kernel, a copy, a
    fill), not a user annotation mirrored on the device's timeline."""
    return (str(ev.device_type).endswith("CUDA")
            and not getattr(ev, "is_user_annotation", False))


def device_ops(prof) -> Dict[str, Tuple[float, int]]:
    """{device operation: (its device ms in total, its count)} of a
    profile, the most time first: every kernel by its symbol, copies and
    fills."""
    ops = {}
    for ev in prof.key_averages():
        if _on_device(ev):
            ops[ev.key] = (ev.self_device_time_total / 1e3, ev.count)
    return dict(sorted(ops.items(), key=lambda kv: -kv[1][0]))


def device_idle_share(prof) -> float:
    """The share of a profile's window (its first event's start to its last
    event's end, host and device) in which the device ran no operation."""
    events = prof.events()
    if not events:
        raise ValueError("device_idle_share: the profile has no event")
    start = min(ev.time_range.start for ev in events)
    end = max(ev.time_range.end for ev in events)
    busy, reach = 0.0, start
    for s, e in sorted((ev.time_range.start, ev.time_range.end)
                       for ev in events if _on_device(ev)):
        if e > reach:
            busy += e - max(s, reach)
            reach = e
    return 1.0 - busy / (end - start) if end > start else 0.0
