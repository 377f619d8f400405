"""device_idle.train: the share of the traced stretch in which the card
ran no operation (``harness/trace.py::summarize``)."""


def read(run):
    s = run.summary
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
