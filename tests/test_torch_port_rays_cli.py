"""The mesh's ``rays`` axis at the port's entry points, on the CPU: the
CLI (``python -m implicit_depth_torch.main``) as 4 ranks of a gloo group at
``training.batch_size: 2`` (data 2 × rays 2) against one process, and
``DepthCompleter(mesh=...)`` on a (2, 2) grid of CPU devices against one
device and against the JAX package's ``DepthCompleter(mesh="auto")`` on
the 8 virtual CPU devices.

Bounds: the CLI's losses rtol 1e-3 and its parameters those of the JAX
package's two-process test (as ``test_torch_port_parallel_cli.py``), the
test CSV the bits of one process's; serving as each test states, input
depth bit for bit.
"""

import json
import os.path as osp
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_multiprocess import _assert_params_close
from test_torch_port_parallel import (
    REPO,
    assert_ok,
    free_port,
    rank_env,
    wait_all,
)
from test_torch_port_parallel_cli import TINY
from test_torch_port_slice import randomize

from implicit_depth_torch.builder import build_lidf, build_refine, build_static
from implicit_depth_torch.config import load_config
from implicit_depth_torch.data.synthetic import synthetic_batch
from implicit_depth_torch.infer import DepthCompleter, device_grid
from implicit_depth_torch.main import main
from implicit_depth_torch.weights import lidf_from_jax, refine_from_jax
from implicit_depth_tpu.builder import build_lidf as jax_build_lidf
from implicit_depth_tpu.builder import build_refine as jax_build_refine
from implicit_depth_tpu.builder import build_static as jax_build_static
from implicit_depth_tpu.config import load_config as jax_load_config
from implicit_depth_tpu.infer import DepthCompleter as JaxDepthCompleter
from implicit_depth_tpu.models import lidf as jlidf

torch.set_num_threads(2)
WORLD = 4
# the global batch of 2 on 4 ranks: data 2 x rays 2
# 2 steps: at one image a data rank, after 4 Adam steps the parameters leave
# the two-process bounds for 2 ranks of the data-parallel layout too (data 2
# x rays 1; 925 of conv1's 9,408 elements, on the CPU), while after 1 and
# 2 steps every tensor is within them
SETS = ["training.batch_size=2", "tpu.train_steps_per_call=1",
        "training.nepochs=1", "dataset.synthetic_len=4"]


def launch(log_dirs, *sets):
    """The CLI on WORLD ranks, rank r logging under ``log_dirs[r]``,
    started; ``finish`` waits for them."""
    port = free_port()
    return [subprocess.Popen(
        [sys.executable, "-m", "implicit_depth_torch.main", *TINY,
         f"base_log_dir={d}", *SETS, *sets], cwd=REPO,
        env=rank_env(r, WORLD, port), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r, d in enumerate(log_dirs)]


def finish(procs):
    """Each rank's output, after every rank exited 0."""
    return assert_ok(wait_all(procs, 180))


def epoch_log(workdir):
    with open(osp.join(workdir, "epoch_log.jsonl")) as f:
        return [json.loads(line) for line in f.read().splitlines()]


def params(workdir):
    state = torch.load(osp.join(workdir, "ckpt", "latest_network",
                                "state.pt"), weights_only=True)
    return {k: v.numpy() for k, v in state["model"].items()}


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """One process and 4 ranks, each training 1 epoch of 2 steps
    (validated) and then
    writing the test CSV from its own checkpoint."""
    base = tmp_path_factory.mktemp("rays_cli")
    ranks = [base / "four"] + [base / f"four_rank{r}" for r in range(1, 4)]
    started = launch(ranks)
    one = main([*TINY, f"base_log_dir={base / 'one'}", *SETS])
    logs = finish(started)
    test_sets = ["exp_type=test",
                 f"checkpoint_path={base / 'four' / 'run' / 'ckpt'}"]
    test_ranks = [base / "test"] + [base / f"test_rank{r}"
                                     for r in range(1, 4)]
    started = launch(test_ranks, *test_sets)
    one_test = main([*TINY, f"base_log_dir={base / 'one_test'}", *SETS,
                     *test_sets])
    finish(started)
    return {"logs": logs, "one": one, "one_test": one_test, "ranks": ranks,
            "test_ranks": test_ranks}


def test_four_ranks_train_the_global_batch_of_2_as_one_process(cli_runs):
    one = cli_runs["one"]
    assert (one.per_host_batch, one.steps_per_epoch) == (2, 2)
    for r, log in enumerate(cli_runs["logs"]):
        assert re.search(rf"\[rank {r}/4\] per_host_batch 1 steps_per_epoch "
                         rf"2 device cpu layout data 2 x rays 2 at data "
                         rf"{r // 2}, rays {r % 2}", log), log[-2000:]
    got = epoch_log(cli_runs["ranks"][0] / "run")
    want = epoch_log(one.workdir)
    assert [e["epoch"] for e in got] == [e["epoch"] for e in want] == [0]
    for a, b in zip(want, got):
        for w, g in ((a["train"], b["train"]),
                     (a["valid"]["synthetic"], b["valid"]["synthetic"])):
            for key in w:
                if key != "epoch_time_s":
                    np.testing.assert_allclose(g[key], w[key], rtol=1e-3,
                                               atol=1e-5, err_msg=key)
    _assert_params_close(params(cli_runs["ranks"][0] / "run"),
                         params(one.workdir))


def test_four_ranks_only_rank_0_writes(cli_runs):
    for d in (*cli_runs["ranks"][1:], *cli_runs["test_ranks"][1:]):
        assert not d.exists(), d
    run = cli_runs["ranks"][0] / "run"
    for name in ("config.yaml", "epoch_log.jsonl", "valid_log.txt",
                 "ckpt/latest_network/state.pt",
                 "ckpt/best_network/state.pt"):
        assert (run / name).exists(), name


def test_four_rank_test_csv_is_one_process_csv(cli_runs):
    """Every eval frame's rays split over the 4 ranks, the outputs gathered:
    the CSV is the bits of one process's."""
    want = open(osp.join(cli_runs["one_test"].result_dir,
                         "synthetic.csv")).read()
    got = (cli_runs["test_ranks"][0] / "run" / "result" /
           "synthetic.csv").read_text()
    assert got == want
    assert want.splitlines()[-1].startswith("MEAN,")


# -- DepthCompleter on a grid of devices -----------------------------------------

H, W = 48, 64
MODES = {"per_ray": {},
         # a budget of 1 pair a ray: the global selection drops pairs
         "global": {"pairs_budget_mode": "global", "pairs_budget_per_ray": 1},
         "dense": {"pairs_budget_per_ray": 0}}


def serve_overrides(mode):
    # every valid pixel a point (no random draw), K=12 > kb=8 for per_ray
    return {
        "mask_type": "all",
        "dataset": {"img_height": H, "img_width": W},
        "model": {"rgb_out": 8, "pnet_out": 16, "pnet_gf": 8, "imnet_gf": 8,
                  "resnet_stages": [1, 1, 1, 1]},
        "refine": {"pnet_out": 16, "pnet_gf": 8, "imnet_gf": 8},
        "grid": {"res": 8, "valid_sample_num": -1},
        "tpu": {"max_pairs_per_ray": 12, "pairs_budget_per_ray": 8,
                "use_pallas_decode": False, "compute_dtype": "float32",
                **MODES[mode]},
    }


@pytest.fixture(scope="module")
def serving():
    """JAX variables at unit activation scale, two frames."""
    jcfg = jax_load_config(overrides=serve_overrides("per_ray"))
    jstatic = jax_build_static(jcfg, n_rays=H * W)
    jl, jr = jax_build_lidf(jcfg, jstatic), jax_build_refine(jcfg, jstatic)
    raw = synthetic_batch(71, 2, H, W)
    jin = jax.jit(lambda b, k: jlidf.prepare_inputs(
        jstatic, b, k, train=False))({k: jnp.asarray(v) for k, v in
                                      raw.items()}, jax.random.key(0))
    rng = np.random.default_rng(71)
    lvars = randomize(jax.device_get(jax.jit(lambda k, i: jl.init(
        k, i, train=False, use_gt_label=False))(jax.random.key(1), jin)), rng)
    lout = jax.jit(lambda v, i: jl.apply(v, i, train=False,
                                         use_gt_label=False))(lvars, jin)
    rparams = randomize(jax.device_get(jax.jit(lambda k, i, o: jr.init(
        k, i, o, o["pred_pos"]))(jax.random.key(2), jin, lout))["params"], rng)
    frames = [(np.asarray(raw["rgb"][i]), np.asarray(raw["depth_corrupt"][i]),
               tuple(float(raw[k][i]) for k in ("fx", "fy", "cx", "cy")))
              for i in range(2)]
    return lvars, rparams, frames


def _port_completer(lvars, rparams, mode, **kw):
    cfg = load_config(overrides=serve_overrides(mode))
    static = build_static(cfg, n_rays=H * W)
    refine = None if rparams is None else refine_from_jax(
        rparams, build_refine(cfg, static))
    return DepthCompleter(cfg, lidf=lidf_from_jax(lvars,
                                                  build_lidf(cfg, static)),
                          refine=refine, batch_size=2, device="cpu", **kw)


GRID = [["cpu", "cpu"], ["cpu", "cpu"]]


@pytest.mark.parametrize("mode", list(MODES))
def test_completer_on_a_grid_matches_jax_mesh_auto(serving, mode):
    """Stage 1 alone, as ``tests/test_infer.py:137``'s case: the (2, 2) grid
    against JAX's (2, 4) mesh. The grid moves the port's depth by less than
    1e-6 from its one device's, as the mesh moves JAX's from its single
    device's (measured 1.8e-7 and 2.4e-7 both); the two packages differ by
    their f32 algebra summed in other orders (2.1-2.3e-5 here, one device
    each), held to ``test_torch_port_slice.py``'s 1e-4. Input depth bit
    for bit."""
    lvars, _, frames = serving
    args = [list(x) for x in zip(*frames)]
    grid = _port_completer(lvars, None, mode, mesh=GRID)
    assert grid.lidf.decode_mode == mode
    got = grid.complete_batch(*args)
    one = _port_completer(lvars, None, mode).complete_batch(*args)
    jcfg = jax_load_config(overrides=serve_overrides(mode))
    jdc = JaxDepthCompleter(jcfg, lidf_variables=lvars, batch_size=2,
                            mesh="auto")
    assert jdc.mesh.devices.shape == (2, 4)
    jout = jdc.complete_batch(*args)
    jone = JaxDepthCompleter(jcfg, lidf_variables=lvars,
                             batch_size=2).complete_batch(*args)
    for i, (_, depth, _) in enumerate(frames):
        have = depth != 0
        assert have.any() and (~have).any()
        assert got["depth"][i][have].tobytes() == depth[have].tobytes()
    np.testing.assert_allclose(got["depth"], one["depth"], atol=1e-6, rtol=0)
    np.testing.assert_allclose(jout["depth"], jone["depth"], atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(got["depth"], np.asarray(jout["depth"]),
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("mode", list(MODES))
def test_completer_on_a_grid_matches_one_device(serving, mode):
    """Both stages. A (1, 2) grid (both frames on each device, the rays
    split): the bits of one device. The (2, 2) grid (one frame a device):
    within 1e-5 (measured 1.2e-6; the trunk's f32 convolutions and batch
    statistics over one frame)."""
    lvars, rparams, frames = serving
    args = [list(x) for x in zip(*frames)]
    want = _port_completer(lvars, rparams, mode).complete_batch(*args)
    rays = _port_completer(lvars, rparams, mode,
                           mesh=[["cpu", "cpu"]]).complete_batch(*args)
    grid = _port_completer(lvars, rparams, mode,
                           mesh=GRID).complete_batch(*args)
    for k in ("depth", "depth_pred"):
        np.testing.assert_array_equal(rays[k], want[k], err_msg=k)
        np.testing.assert_allclose(grid[k], want[k], atol=1e-5, rtol=0,
                                   err_msg=k)


def test_device_grid_rules():
    assert device_grid(None, 2) is None
    assert device_grid([["cpu", "cpu"]], 3) == [[torch.device("cpu")] * 2]
    with pytest.raises(ValueError, match="multiple of the mesh's data axis"):
        device_grid([["cpu"], ["cpu"]], 3)
    with pytest.raises(ValueError, match="every row as long"):
        device_grid([["cpu", "cpu"], ["cpu"]], 2)
    with pytest.raises(ValueError, match="'auto'"):
        device_grid("all", 2)


def test_auto_grid_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_grid("auto", 2)
