"""The work counted from widths and shapes, against hand-worked values."""

import json

import pytest
from conftest import ROOT

from benchmark.harness import counts


def _cfg(name):
    return json.loads((ROOT / "benchmark" / "configs" / f"{name}.json"
                       ).read_text())


def test_k1_frame_least_time():
    """K1 at one 240×320 frame (76,800 rays × 8 pairs), bf16: compute
    bound at 0.31 ms, as the port's kernel table has it."""
    cfg = _cfg("lidf_rn34_gf64")
    flops, nbytes = counts.decode(cfg, 1, 76_800)
    g1, g2, g3 = 256, 128, 64
    tail = g1 * g2 + g2 * g3 + g3
    hand = 2 * (76_800 * 8 * ((128 + 6 + 96) * 2 * g1 + 3 * tail)
                + 76_800 * (128 + 27) * 2 * g1)
    assert flops == hand
    least = counts.least_seconds(flops, nbytes, "bfloat16")
    assert least == pytest.approx(flops / 989e12)
    assert least * 1e3 == pytest.approx(0.3115, abs=5e-4)


def test_backward_counts_twice_the_forward():
    cfg = _cfg("lidf_rn34_gf64")
    f, b = counts.decode(cfg, 32, 20_000)
    fb, bb = counts.decode(cfg, 32, 20_000, backward=True)
    assert fb == 3 * f and bb > 2 * b


def test_model_flops_of_a_served_frame():
    """The reference's products and convolutions of a 240×320 frame
    through both stages: the ResNet34-8s, the PointNets and the decoders."""
    from benchmark.harness import flops
    cfg = _cfg("lidf_refine_rn34_gf64")
    t = {"batch": 1, "height": 240, "width": 320}
    one = flops.serve(cfg, t)
    assert 2e11 < one < 8e11
    assert flops.serve(cfg, {**t, "batch": 2}) == pytest.approx(2 * one)
