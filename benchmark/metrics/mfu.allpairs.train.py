"""mfu.allpairs.train: the operations of a stage-1 step that decodes every
valid pair once (the plain reference's products and convolutions at the
step's shapes, forward and backward, with the decode counted over the
traffic pool's valid pairs only; ``harness/pair_counts.py``) over the
window's time and the card's dense bf16 peak (``peaks.json``)."""

from benchmark.harness import counts, pair_counts


def read(run):
    d = run.driver
    return 100.0 * pair_counts.allpairs_step_flops(d) * d.steps \
        / d.window_s / counts.peak_flops("bfloat16")
