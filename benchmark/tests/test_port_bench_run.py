"""Each cell's driver end to end on the CPU at a tiny size, against the
program's plain kernels: one result line of the contract, ``correct``
true; and the harness's own refusals."""

import json
import os
import subprocess
import sys

import pytest
from conftest import CELLS, ROOT, run_cell

KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_is_correct(tiny_root, cell, trace):
    from benchmark.harness import spec
    c = spec.load_cell(cell, tiny_root)
    rc, line = run_cell(tiny_root, cell, trace=trace)
    assert rc == 0
    assert KEYS <= set(line) and list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    want = [m["name"] for m in (c.per_layer if trace else c.end_to_end)]
    got = set(line["metrics"])
    if trace:  # a reader that finds nothing leaves its metric out
        assert got <= set(want) and got
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert got == set(want)
    for m in line["metrics"].values():
        assert m["value"] == m["value"] and m["unit"]
    assert set(line["checks"]) == set(c.workload["limits"])


def test_forbidden_modules_by_top_level_name(monkeypatch):
    from benchmark.harness.main import forbidden_modules
    for m in ("jax.numpy", "implicit_depth_tpu.models", "flax"):
        monkeypatch.setitem(sys.modules, m, object())
    monkeypatch.setitem(sys.modules, "jaxfoo", object())
    found = forbidden_modules()
    assert {"jax.numpy", "implicit_depth_tpu.models", "flax"} <= set(found)
    assert "jaxfoo" not in found
    assert not any(m.startswith("implicit_depth_torch") for m in found)


def test_a_run_loads_no_jax(tiny_root):
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r});"
            "import contextlib, io, pathlib;"
            "from benchmark.harness.main import main, forbidden_modules;"
            "out = io.StringIO();"
            "ctx = contextlib.redirect_stdout(out); ctx.__enter__();"
            f"rc = main(['--workload', 'serve.refine.b8', '--seed', '5',"
            f" '--seconds', '0.3', '--trace', '0'],"
            f" root=pathlib.Path({str(tiny_root)!r}), device='cpu');"
            "ctx.__exit__(None, None, None);"
            "print(rc, forbidden_modules())")
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=600)
    assert res.stdout.strip().splitlines()[-1] == "0 []", res.stderr[-2000:]


def test_no_card_no_result():
    """Without the card the cell asks for, the run exits with another code
    than 0 and prints no result."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA device")
    res = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "serve.refine.b8", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode != 0 and res.stdout.strip() == ""


def test_benchmark_alone_no_result(tmp_path):
    """In a directory with BENCHMARK.json and the benchmark's files alone
    (no program), a run exits with another code than 0 and no result."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "serve.refine.b8", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode != 0
    assert not any(line.startswith("{") for line in res.stdout.splitlines())
    json.loads((tmp_path / "BENCHMARK.json").read_text())
