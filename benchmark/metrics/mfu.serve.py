"""mfu.serve: the model's operations of the calls completed in the window
(the plain reference's products and convolutions at a call's shapes,
``harness/flops.py``) over the window's time and the card's dense bf16
peak (``peaks.json``)."""

from benchmark.harness import counts


def read(run):
    d = run.driver
    calls = d.units() / d.batch
    return 100.0 * d.model_flops() * calls / d.window_s \
        / counts.peak_flops("bfloat16")
