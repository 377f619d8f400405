"""Tracing and profiling of the port (the counterpart of
``implicit_depth_tpu/utils/profiling.py``).

- :func:`span`: the program's spans, one registry. A span costs one check
  while tracing is off (the default). Tracing is on while a
  ``torch.profiler`` profile records and between :func:`enable` and
  :func:`disable`; a span then opens ``torch.profiler.record_function``
  (when a profiler records, so that the trace names it on its own clock),
  appends a :class:`SpanRecord` to a ring of the last :data:`RING` spans
  (:func:`spans`) and adds to per-name sums (:func:`span_totals`).
- :func:`stage_timer` / :func:`stage_times`: a span that records whether
  or not tracing is on, and the registry's sums in seconds; ``sync`` waits
  for the device the stage ran on before the stage is closed (PyTorch
  returns before a card has finished).
- :func:`interleaved_slope`: seconds per iteration from two loops of
  ``iters_a`` and ``iters_b`` iterations, timed in interleaved pairs (the
  median pair difference), robust to a slow first measured run.
- :func:`device_slope_time`: seconds per call of a function that returns a
  device scalar, from runs of ``iters_a`` and ``iters_b`` calls launched
  back to back, each run read back once.
- :func:`trace`: a ``torch.profiler`` trace of a block (CPU, and the card's
  activity when the work is on one), written as a Chrome trace;
  :func:`device_ops`, :func:`device_idle_share` and :func:`idle_by_span`
  read what it recorded.

The program's spans, each name prefixed by its layer (a root opens with no
span open on its thread; ``sync.*`` spans hold an operation that makes the
host wait for the card):

- serving, ``infer.py::DepthCompleter``: ``infer.complete_batch`` (root) >
  ``infer.device_batch`` > ``infer.prep_frames``, ``infer.h2d``;
  ``infer.forward`` > ``lidf.prepare_inputs``, ``lidf.trunk``,
  ``lidf.decode_rays``, ``refine.forward``; ``infer.read_back``;
- training, ``train/steps.py``: ``train.step`` (root) >
  ``lidf.prepare_inputs``, ``lidf.trunk``, ``lidf.decode_rays``,
  ``refine.forward``, ``train.loss``, ``train.backward``,
  ``train.optimizer``; ``train/trainer.py``: ``train.to_device``, and in
  the epoch loop ``train.feed_wait``, ``train.dispatch``, ``train.harvest``
  (``IDT_TIMING`` turns tracing on for the epoch and prints their sums);
- the ``global`` and dense modes (``models/lidf.py``,
  ``ops/pair_decode.py``): ``lidf.decode_rays`` > ``lidf.compact_pairs``
  (the ``global`` selection), ``pair_decode.forward`` (K6 in training);
  ``train.backward`` > ``pair_decode.backward`` > ``sync.pair_rows``;
- data parallel (``parallel/mesh.py``): ``train.backward`` >
  ``parallel.all_reduce_grads``.

To see where a served frame or a train step spends the card's time::

    from implicit_depth_torch.utils import profiling

    with profiling.trace("logs/trace") as t:      # tracing on inside
        dc.complete(rgb, depth, intrinsics)
    ops = profiling.device_ops(t.profile)         # {kernel: (device ms, count)}
    idle = profiling.device_idle_share(t.profile)
    by_span = profiling.idle_by_span(t.profile)   # {span: idle s}
    # t.path: the Chrome trace (chrome://tracing, Perfetto)

    profiling.enable()                            # or spans without a profiler
    dc.complete(rgb, depth, intrinsics)
    profiling.disable()
    profiling.span_totals()                       # {span: (count, seconds)}
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import os
import threading
import time
from typing import Callable, Deque, Dict, List, NamedTuple, Optional, Tuple, Union

import torch
import torch.autograd.profiler as _autograd_profiler

# the most span records kept (the oldest dropped first): a served call or a
# train step records under 40, so the ring holds the last thousand or more
RING = 1 << 16
# idle_by_span's key of the gaps outside every span
OUTSIDE = "(outside every span)"


class SpanRecord(NamedTuple):
    """One closed span: host-clock ns (``time.perf_counter``, the clock of
    the benchmark's spans), the ``id`` of the enclosing span (None for a
    root) and of the root span of its call or step."""
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]
    root: int
    id: int


_enabled = 0                # enable() depth
_records: Deque[SpanRecord] = collections.deque(maxlen=RING)
_totals: Dict[str, List] = {}   # name -> [count, seconds]
_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()      # .stack: this thread's open spans
_adopting: Optional["_Span"] = None
_offset_ns: Optional[int] = None
_OFF = contextlib.nullcontext()


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


def _measure_offset() -> None:
    global _offset_ns
    _offset_ns = time.time_ns() - time.perf_counter_ns()


class _Span:
    __slots__ = ("name", "sync", "adopt", "id", "parent", "root", "rf", "t0",
                 "stack", "adopted")

    def __init__(self, name: str, sync=False, adopt: bool = False):
        self.name, self.sync, self.adopt = name, sync, adopt

    def __enter__(self):
        global _adopting
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        up = stack[-1] if stack else _adopting
        self.id = next(_ids)
        self.parent = up.id if up is not None else None
        self.root = up.root if up is not None else self.id
        if up is None and _offset_ns is None:
            _measure_offset()
        self.stack = stack
        stack.append(self)
        if self.adopt:
            self.adopted, _adopting = _adopting, self
        self.rf = None
        if _autograd_profiler._is_profiler_enabled:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        global _adopting
        if self.sync is not False:
            _synchronize(self.sync)
        t1 = time.perf_counter()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        if self.adopt:
            _adopting = self.adopted
        self.stack.pop()
        _records.append(SpanRecord(self.name, int(self.t0 * 1e9),
                                   int(t1 * 1e9), self.parent, self.root,
                                   self.id))
        with _lock:
            total = _totals.setdefault(self.name, [0, 0.0])
            total[0] += 1
            total[1] = total[1] + t1 - self.t0
        return False


def span(name: str, adopt: bool = False):
    """A context manager: the span ``name`` while tracing is on (a profiler
    records, or :func:`enable`), else nothing at all. Its parent is the
    innermost span open on this thread; on a thread with none open, the
    innermost open ``adopt`` span of another thread (``train.backward``:
    autograd runs the backward of a card's operations on a thread of its
    own while the caller waits in ``backward()``)."""
    if _enabled or _autograd_profiler._is_profiler_enabled:
        return _Span(name, adopt=adopt)
    return _OFF


def spanned(name: str):
    """Decorator: every call of the function inside :func:`span` ``name``
    (off, the call and the one check)."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not (_enabled or _autograd_profiler._is_profiler_enabled):
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def enable() -> None:
    """Turn tracing on (nests with :func:`disable`), and measure the offset
    of the spans' clock to the profiler's (:func:`clock_offset_ns`)."""
    global _enabled
    _enabled += 1
    _measure_offset()


def disable() -> None:
    """Undo one :func:`enable`."""
    global _enabled
    _enabled = max(_enabled - 1, 0)


def clock_offset_ns() -> Optional[int]:
    """Unix-epoch ns minus ``perf_counter`` ns, measured at the last
    :func:`enable` (or, where only a profiler turned tracing on, at the
    process's first root span): a record's ``start_ns + offset -
    prof.profiler.kineto_results.trace_start_ns()`` is its place on a
    profile's timeline, in ns (the profile's events are offsets from that
    Unix-epoch start)."""
    return _offset_ns


def open_spans() -> List[str]:
    """The names of the spans open on this thread, outermost first."""
    return [sp.name for sp in getattr(_local, "stack", None) or ()]


def spans() -> List[SpanRecord]:
    """The ring's records, oldest first (a span is recorded when it
    closes)."""
    return list(_records)


def span_totals() -> Dict[str, Tuple[int, float]]:
    """{span: (count, seconds)} summed since the last
    :func:`stage_times` reset, every span recorded (stages included)."""
    with _lock:
        return {k: (n, s) for k, (n, s) in _totals.items()}


def stage_timer(name: str, sync: Union[bool, str, torch.device] = False):
    """A span ``name`` that records whether or not tracing is on: its
    seconds are added to ``name`` in the registry. ``sync``: the device the
    stage ran on (or True: the current CUDA device), waited for before the
    clock is read."""
    return _Span(name, sync=sync)


def stage_times(reset: bool = True) -> Dict[str, float]:
    """{stage: seconds} accumulated since the last reset: the registry's
    sums (every span recorded); ``reset`` clears them."""
    with _lock:
        out = {k: s for k, (_, s) in _totals.items()}
        if reset:
            _totals.clear()
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
    _measure_offset()
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


def _idle_gaps(events):
    """(window start, window end, the device's idle gaps [(start, end)]) of
    a profile's events: the window is its first event's start to its last
    event's end, host and device; a gap is a stretch of it in which the
    device ran no operation."""
    start = min(ev.time_range.start for ev in events)
    end = max(ev.time_range.end for ev in events)
    gaps, reach = [], start
    for s, e in sorted((ev.time_range.start, ev.time_range.end)
                       for ev in events if _on_device(ev)):
        if s > reach:
            gaps.append((reach, s))
        reach = max(reach, e)
    if end > reach:
        gaps.append((reach, end))
    return start, end, gaps


def device_idle_share(prof) -> float:
    """The share of a profile's window (its first event's start to its last
    event's end, host and device) in which the device ran no operation."""
    events = prof.events()
    if not events:
        raise ValueError("device_idle_share: the profile has no event")
    start, end, gaps = _idle_gaps(events)
    return sum(e - s for s, e in gaps) / (end - start) if end > start else 0.0


def idle_by_span(prof) -> Dict[str, float]:
    """{span: device idle seconds} of a profile, the most first: each idle
    gap of :func:`device_idle_share` put down to the innermost program span
    open on the host at the gap's midpoint (of those open then, the last to
    open), as the profile's ``record_function`` annotations place them;
    gaps outside every span under :data:`OUTSIDE`. The parts sum to
    ``device_idle_share(prof)`` times the window. The program's spans are
    the names the registry holds."""
    events = prof.events()
    if not events:
        raise ValueError("idle_by_span: the profile has no event")
    names = set(span_totals()) | {r.name for r in spans()}
    _, _, gaps = _idle_gaps(events)
    opened = sorted((ev.time_range.start, ev.time_range.end, ev.name)
                    for ev in events if ev.name in names
                    and not str(ev.device_type).endswith("CUDA"))
    out: Dict[str, float] = collections.defaultdict(float)
    for s, e in gaps:
        mid, inner = 0.5 * (s + e), OUTSIDE
        for a, b, name in opened:
            if a > mid:
                break
            if b >= mid:
                inner = name
        out[inner] += (e - s) / 1e6
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))
