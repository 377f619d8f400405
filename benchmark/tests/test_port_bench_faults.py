"""The check turns ``correct`` false under each fault that a cell can
have, planted under its timed path (``harness/faults.py``): a training
step that leaves its state unchanged, one that leaves out half of its
batch, a served answer altered where it is produced. The cell's own
limits are held."""

import pytest
from conftest import driver

from benchmark.harness import compare, faults

CASES = [("train.lidf.b32", "frozen"), ("train.lidf.b32", "half_batch"),
         ("train.refine.b32", "frozen"), ("train.refine.b32", "half_batch"),
         ("serve.refine.b8", "altered")]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_not_correct(tiny_root, cell, fault):
    d = driver(tiny_root, cell)
    faults.plant(d, fault)
    d.setup()
    d.window(0.3)
    d.release()
    checks = compare.judge(d.readings(), d.w["limits"])
    assert not all(c["ok"] for c in checks.values()), checks
