"""The control: the plain reference computed with fp8 operands (the step
below the configuration's bfloat16) in the program's place must come out
not correct against each cell's limits: on the card (marked ``cuda``) at
the cell's own size, on each of three seeds. On the CPU at a tiny size
(decoders 8 wide), where fp8 moves the numbers less than at the published
widths, on most of three seeds."""

import pytest
import torch
from conftest import CELLS, driver

from benchmark.harness import compare


def _control_fails(d):
    d.setup()
    d.window(0.5)
    d.release()
    checks = compare.judge(d.readings(against="fp8"), d.w["limits"])
    return not all(c["ok"] for c in checks.values()), checks


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_tiny(tiny_root, cell):
    runs = [_control_fails(driver(tiny_root, cell, seed))
            for seed in (11, 12, 13)]
    assert sum(f for f, _ in runs) >= 2, runs


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from benchmark.harness import spec
    c = spec.load_cell(cell)
    for seed in (2_300_000_001, 2_300_000_002, 2_300_000_003):
        d = spec.driver(c).Driver(c, seed, torch.device("cuda"))
        fails, checks = _control_fails(d)
        assert fails, (seed, checks)
