"""The benchmark as data: BENCHMARK.json keeps to its contract, every
cell, configuration, traffic mix and metric is found by name from its own
file, and a new one is added by adding files and entries alone."""

import json
import re
import shutil

import pytest
from conftest import BENCH, CELLS, ROOT, make_tiny_root, run_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_contract_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics] + CELLS \
        + [c["name"] for c in BENCH["configs"]]
    assert len(set(names)) == len(names)
    for n in names:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert {"setup_s"} <= {m["name"] for m in BENCH["end_to_end"]}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_found_by_name(cell):
    from benchmark.harness import spec
    c = spec.load_cell(cell)
    assert c.workload["driver"] in ("serve", "train")
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.per_layer:
        assert m["moves"] in e2e
        assert callable(spec.reader(c, m["name"]).read)
    assert c.workload["limits"], "the check compares against limits"


def test_config_files_under_paths():
    for c in BENCH["configs"]:
        assert c["file"].startswith("benchmark/configs/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]


def test_a_new_cell_config_traffic_and_metric_are_files(tmp_path):
    """A stage-1-only serving cell on a configuration of its own, with a
    traffic mix and a per-layer metric of its own, runs from files added
    beside the others and entries added to BENCHMARK.json."""
    root = make_tiny_root(tmp_path / "root")
    data = root / "benchmark"
    cfg = json.loads((data / "configs" / "lidf_rn34_gf64.json").read_text())
    cfg.update(name="lidf_new")
    (data / "configs" / "lidf_new.json").write_text(json.dumps(cfg))
    shutil.copy(data / "traffic" / "frames_b8.json",
                data / "traffic" / "frames_new.json")
    (data / "workloads" / "serve.lidf.new.json").write_text(json.dumps(
        {"driver": "serve", "warm_calls": 1, "check_calls": 1,
         "trace_calls": 2, "limits": {"input_depth_changed": 0,
                                      "pair_slots_differ": 0,
                                      "prob_gap": 1e-3}}))
    (data / "metrics" / "calls_traced.new.py").write_text(
        "def read(run):\n    return float(run.driver.traced_iters)\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "lidf_new", "source": "x",
                             "file": "benchmark/configs/lidf_new.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "serve.lidf.new", "config": "lidf_new",
                               "traffic": "frames_new", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "serve_frames_per_s":
            m["workloads"].append("serve.lidf.new")
    bench["per_layer"].append({"name": "calls_traced.new", "unit": "calls",
                               "better": "higher", "source": "host_clock",
                               "layer": "test", "moves": "serve_frames_per_s",
                               "workloads": ["serve.lidf.new"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    rc, line = run_cell(root, "serve.lidf.new", trace=1)
    assert rc == 0 and line["correct"] is True
    assert line["metrics"]["calls_traced.new"]["value"] == 2.0
    rc, line = run_cell(root, "serve.lidf.new", trace=0)
    assert set(line["metrics"]) == {"setup_s", "serve_frames_per_s"}
