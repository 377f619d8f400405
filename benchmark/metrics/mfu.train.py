"""mfu.train: the model's operations of the steps completed in the window
(the plain reference's products and convolutions at a step's shapes: the
trained model's forward and backward, a frozen stage 1's forward;
``harness/flops.py``) over the window's time and the card's dense bf16
peak (``peaks.json``)."""

from benchmark.harness import counts


def read(run):
    d = run.driver
    return 100.0 * d.model_flops() * d.steps / d.window_s \
        / counts.peak_flops("bfloat16")
