"""dispatch_ms.train: the mean host-clock time of a training step's call,
from the call to its return (before any read-back), over every step of
the window, from the benchmark's span around it."""

NAME = "step_call"


def read(run):
    d = [t1 - t0 for n, t0, t1 in run.spans if n == NAME]
    return 1e3 * sum(d) / len(d) if d else None
