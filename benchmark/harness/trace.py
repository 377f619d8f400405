"""Spans and the device trace of a ``--trace 1`` run.

:class:`Spans` records host-clock spans around the calls into the
program's layers (the drivers wrap them), and, while a profiler records,
marks each with ``torch.profiler.record_function`` so that the trace names
what the host did. :func:`summarize` reads a ``torch.profiler`` profile:
each device operation's time by symbol, the device's busy time over the
traced window, and the idle gaps by the innermost span that the host was
in (a frozen copy of the arithmetic of the program's profiling module:
device events are those on the device that are no user annotation; busy
time is the union of their intervals).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch


class Spans:
    """Host-clock spans: (name, start s, end s), in memory."""

    def __init__(self):
        self.records: List[Tuple[str, float, float]] = []
        self.annotate = False

    @contextlib.contextmanager
    def span(self, name: str):
        ctx = (torch.profiler.record_function(name) if self.annotate
               else contextlib.nullcontext())
        t0 = time.perf_counter()
        with ctx:
            yield
        self.records.append((name, t0, time.perf_counter()))

    def wrap(self, obj, attr: str, name: str):
        """Replace ``obj.attr`` (a callable) by one inside span ``name``."""
        inner = getattr(obj, attr)

        def spanned(*a, **kw):
            with self.span(name):
                return inner(*a, **kw)

        setattr(obj, attr, spanned)


def activities(dev):
    """The profiler's activities: the host, and the card where one runs."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _on_device(ev) -> bool:
    return (str(ev.device_type).endswith("CUDA")
            and not getattr(ev, "is_user_annotation", False))


def summarize(prof, span_names) -> Dict:
    """{"ops": {symbol: (device s, count)}, "busy_s", "window_s", "gaps":
    {span: idle s}} of a profile (times in seconds)."""
    ops = {}
    for ev in prof.key_averages():
        if _on_device(ev):
            ops[ev.key] = (ev.self_device_time_total / 1e6, ev.count)
    events = prof.events()
    start = min(ev.time_range.start for ev in events)
    end = max(ev.time_range.end for ev in events)
    merged = []
    for s, e in sorted((ev.time_range.start, ev.time_range.end)
                       for ev in events if _on_device(ev)):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged)
    holes, reach = [], start
    for s, e in merged:
        if s > reach:
            holes.append((reach, s))
        reach = max(reach, e)
    if end > reach:
        holes.append((reach, end))
    spans = sorted((ev.time_range.start, ev.time_range.end, ev.name)
                   for ev in events
                   if ev.name in span_names and not _on_device(ev))
    gaps = defaultdict(float)
    for s, e in holes:
        mid, inner = 0.5 * (s + e), "(outside every span)"
        for a, b, name in spans:
            if a > mid:
                break
            if b >= mid:
                inner = name  # the latest-starting span around it
        gaps[inner] += (e - s) / 1e6
    return {"ops": dict(sorted(ops.items(), key=lambda kv: -kv[1][0])),
            "busy_s": busy / 1e6, "window_s": (end - start) / 1e6,
            "gaps": dict(sorted(gaps.items(), key=lambda kv: -kv[1]))}


def device_seconds(summary: Dict, patterns) -> Tuple[float, int]:
    """(device s, launches) of the operations whose symbol holds any of
    ``patterns`` (regular expressions)."""
    import re
    rx = [re.compile(p) for p in patterns]
    secs, count = 0.0, 0
    for name, (s, c) in summary["ops"].items():
        if any(r.search(name) for r in rx):
            secs += s
            count += c
    return secs, count
