"""The program's own spans (``implicit_depth_torch/utils/profiling.py``)
of a ``--trace 1`` run's traced stretch, for the per-layer metrics that
read them: a span's host time less the waits for the card inside it (its
``sync.*`` spans, which only ``sync_wait_ms.*`` counts). Nothing where the
program keeps no spans."""

from __future__ import annotations

from typing import Iterable, List, Optional

WAIT = "sync."


def traced_records(run) -> Optional[List]:
    """The span records of the traced stretch: those opened after the
    window's last benchmark span (set-up's profiled step came before the
    window, on the same clock); None without ``profiling.spans``."""
    try:
        from implicit_depth_torch.utils.profiling import spans
    except ImportError:
        return None
    after = max((t1 for _, _, t1 in run.spans), default=0.0) * 1e9
    return [r for r in spans() if r.start_ns > after]


def own_ms(run, names: Iterable[str]) -> Optional[float]:
    """Mean host ms a step of the spans named ``names`` (each counted where
    it is not inside another of them), less the union of the outermost
    waits inside each; None where no such span was recorded."""
    names = set(names)
    recs = traced_records(run)
    if not recs:
        return None
    by_id = {r.id: r for r in recs}

    def outer(r, stop):  # the nearest enclosing span that passes ``stop``
        up = by_id.get(r.parent)
        while up is not None and not stop(up):
            up = by_id.get(up.parent)
        return up

    mine = [r for r in recs if r.name in names
            and outer(r, lambda u: u.name in names) is None]
    ids = {r.id for r in mine}
    waits = {}
    for r in recs:
        if not r.name.startswith(WAIT):
            continue
        up = outer(r, lambda u: u.name.startswith(WAIT) or u.id in ids)
        if up is not None and up.id in ids:
            waits.setdefault(up.id, []).append((r.start_ns, r.end_ns))
    d = []
    for r in mine:
        own, reach = r.end_ns - r.start_ns, r.start_ns
        for s, e in sorted(waits.get(r.id, ())):  # their union, once
            own -= max(0, e - max(s, reach))
            reach = max(reach, e)
        d.append(own)
    return 1e-6 * sum(d) / run.driver.traced_iters if d else None
