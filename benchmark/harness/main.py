"""One run of one cell: set-up, the measured window, (``--trace 1``) a
traced stretch after it, then the check against the plain reference, and
one JSON line of results as the last line of standard output.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

With ``--trace 0`` the line holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer ones. Exits 2, printing no result, without
the cards the cell asks for, and 3 if a module of JAX or of the JAX
package is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Dict, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "implicit_depth_tpu")
# the process's CPU threads: the load comes from one process with few
# threads, so that it contends less with what else the host runs
HOST_THREADS = 2


def forbidden_modules():
    """The loaded modules whose top-level name is JAX's or the JAX
    package's (the name before the first dot, compared whole)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


class Run:
    """What a per-layer metric's reader reads: the cell, the driver (its
    counts and its work a call or step), the spans of the window ((name,
    start s, end s)) and the summary of the traced stretch
    (``harness/trace.py::summarize``)."""

    def __init__(self, cell, driver, spans, summary):
        self.cell, self.driver = cell, driver
        self.spans, self.summary = spans, summary


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, root: Optional[Path] = None, device: Optional[str] = None,
         t_start: Optional[float] = None) -> int:
    """``device`` None: the card, which must be there (the benchmark's
    own runs); a tests' run on the CPU names "cpu"."""
    t_start = time.perf_counter() if t_start is None else t_start
    args = _args(argv)
    import gc

    import torch
    torch.set_num_threads(HOST_THREADS)

    from benchmark.harness import spec
    cell = spec.load_cell(args.workload, root or spec.ROOT)
    chips = int(cell.entry.get("chips", 1))
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"benchmark: the cell needs {chips} CUDA device(s); "
                  f"found {torch.cuda.device_count()}", file=sys.stderr)
            return 2
        device = "cuda"
    dev = torch.device(device)

    drv = spec.driver(cell).Driver(cell, args.seed, dev, trace=bool(args.trace))
    drv.setup()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    gc.freeze()  # set-up's objects are not scanned again in the window
    drv.window(args.seconds)
    summary = drv.traced_stretch() if args.trace else None
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    drv.release()
    checks = drv.check()
    correct = all(c["ok"] for c in checks.values())

    metrics: Dict[str, Dict] = {}
    if args.trace:
        run = Run(cell, drv, drv.window_spans, summary)
        for m in cell.per_layer:
            v = spec.reader(cell, m["name"]).read(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = {**drv.end_to_end(), "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    out = {"correct": correct, "attempted": drv.attempted,
           "failed": drv.failed, "metrics": metrics,
           "device": _device(dev, chips, peak)}
    if summary is not None:
        out["device"].update(busy_s=summary["busy_s"],
                             window_s=summary["window_s"])
        out["breakdown"] = {
            "device_ops": [[k, v[0]] for k, v in
                           list(summary["ops"].items())[:10]],
            "idle_gaps": [[k, v] for k, v in
                          list(summary["gaps"].items())[:10]]}
    out["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                     for k, c in checks.items()}
    found = forbidden_modules()
    if found:
        print("benchmark: modules of JAX or of the JAX package are loaded: "
              + ", ".join(found), file=sys.stderr)
        return 3
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})"
              f"{'' if c['ok'] else ' FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


def _device(dev, chips: int, peak: int) -> Dict:
    import torch
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": chips, "memory_peak_bytes": peak}
