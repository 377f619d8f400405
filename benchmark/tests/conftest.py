"""Fixtures of the benchmark's CPU tests: a copy of the benchmark at a tiny
size (48×64 frames, narrow layers, a few hundred rays), float32 on the
CPU, where the program runs its plain kernels."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


def make_tiny_root(dst: Path) -> Path:
    """``dst`` holding BENCHMARK.json and the benchmark's drivers, metrics,
    workloads (limits included) as they are, and its configurations and
    traffic cut to a tiny size."""
    (dst / "benchmark").mkdir(parents=True)
    for d in ("drivers", "metrics", "workloads"):
        shutil.copytree(ROOT / "benchmark" / d, dst / "benchmark" / d)
    for d in ("configs", "traffic"):
        (dst / "benchmark" / d).mkdir()
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        cfg["dataset"] = {"img_height": 48, "img_width": 64}
        cfg["model"].update(rgb_out=8, pnet_out=16, pnet_gf=8, imnet_gf=8)
        if "refine" in cfg:
            cfg["refine"].update(pnet_out=16, pnet_gf=8, imnet_gf=8)
        cfg["grid"].update(miss_sample_num=256, valid_sample_num=256)
        cfg["tpu"]["compute_dtype"] = "float32"
        (dst / c["file"]).write_text(json.dumps(cfg))
    for w in BENCH["workloads"]:
        path = ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json"
        t = json.loads(path.read_text())
        t.update(batch=2 if t["batch"] < 16 else 4, height=48, width=64)
        (dst / "benchmark" / "traffic" / path.name).write_text(json.dumps(t))
    shutil.copy(ROOT / "BENCHMARK.json", dst)
    return dst


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_tiny_root(tmp_path_factory.mktemp("bench") / "root")


def run_cell(root, cell, trace=0, seed=3_000_000_019, seconds=0.5):
    """One run of ``cell`` on the CPU -> (exit code, its result line or
    None)."""
    import contextlib
    import io

    from benchmark.harness.main import main
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(["--workload", cell, "--seed", str(seed), "--seconds",
                   str(seconds), "--trace", str(trace)], root=root,
                  device="cpu")
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)


def driver(root, cell, seed=3_000_000_019):
    import torch

    from benchmark.harness import spec
    c = spec.load_cell(cell, root)
    return spec.driver(c).Driver(c, seed, torch.device("cpu"))
