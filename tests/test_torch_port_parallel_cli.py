"""The port's CLI as two processes of a gloo process group against one
process, on the CPU (``python -m implicit_depth_torch.main`` with
torchrun's variables set by hand, each rank a subprocess with a timeout):
the global batch split into the ranks' blocks, the epoch losses and the
final parameters of the one-process run on the global batch, only rank 0
writing files, and a 2-rank mid-epoch resume bit for bit.

Bounds: the losses rtol 1e-3; the parameters those of the JAX package's
two-process test (``test_multiprocess.py::_assert_params_close``): Adam
turns float reassociation into a full step on the odd element whose
gradient sits near zero.
"""

import json
import os.path as osp
import re
import subprocess
import sys

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

from implicit_depth_torch.main import main

torch.set_num_threads(2)

WORLD = 2
TINY = ["--device", "cpu", "--cfg_paths",
        str(REPO / "configs" / "smoke_synthetic.yaml"), "--set",
        "log_name=run", "resume=None", "dataset.img_width=64",
        "dataset.img_height=48", "dataset.synthetic_len=8",
        "grid.miss_sample_num=256", "grid.valid_sample_num=256",
        "tpu.max_pairs_per_ray=8", "tpu.compute_dtype=float32",
        "model.rgb_out=8", "model.pnet_out=16", "model.pnet_gf=8",
        "model.imnet_gf=8", "model.resnet_stages=[1, 1, 1, 1]",
        "training.batch_size=4", "training.valid_batch_size=2",
        "training.nepochs=2", "training.log_interval=1",
        "training.ckpt_every_steps=1"]

# a rank whose train step raises at its second call (after the mid-epoch
# checkpoint of step 1), as a preempted run does
DYING = r'''
import sys
from implicit_depth_torch import main
from implicit_depth_torch.train import trainer

real = trainer.make_lidf_train_step


def dying_make(*a, **kw):
    step, calls = real(*a, **kw), [0]

    def dying(*sa, **skw):
        if calls[0] >= 1:
            raise RuntimeError("simulated preemption")
        calls[0] += 1
        return step(*sa, **skw)
    return dying


trainer.make_lidf_train_step = dying_make
main.main(sys.argv[1:])
'''


def launch(log_dirs, k, *sets, code=None):
    """The CLI (or ``code`` given the CLI's arguments) on WORLD ranks, rank
    r logging under ``log_dirs[r]``; each rank's (return code, output)."""
    port = free_port()
    procs = []
    for r, log_dir in enumerate(log_dirs):
        argv = [*TINY, f"base_log_dir={log_dir}",
                f"tpu.train_steps_per_call={k}", *sets]
        cmd = ([sys.executable, "-c", code] if code
               else [sys.executable, "-m", "implicit_depth_torch.main"])
        procs.append(subprocess.Popen(
            cmd + argv, cwd=REPO, env=rank_env(r, WORLD, port),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return wait_all(procs)


def epoch_log(workdir):
    with open(osp.join(workdir, "epoch_log.jsonl")) as f:
        return [json.loads(line) for line in f.read().splitlines()]


def params(workdir):
    state = torch.load(osp.join(workdir, "ckpt", "latest_network",
                                "state.pt"), weights_only=True)
    return {k: v.numpy() for k, v in state["model"].items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One run of each kind, made on first use: ("one", k) in this process,
    ("two", k) as two ranks."""
    base = tmp_path_factory.mktemp("cli")
    made = {}

    def get(kind, k):
        if (kind, k) not in made:
            d = base / f"{kind}_k{k}"
            if kind == "one":
                tr = main([*TINY, f"base_log_dir={d}",
                           f"tpu.train_steps_per_call={k}"])
                made[kind, k] = (tr.workdir, [f"per_host_batch "
                                              f"{tr.per_host_batch} "
                                              f"steps_per_epoch "
                                              f"{tr.steps_per_epoch}"])
            else:
                logs = assert_ok(launch([d, base / f"{kind}_k{k}_rank1"], k))
                made[kind, k] = (str(d / "run"), logs)
        return made[kind, k]
    return get


@pytest.mark.parametrize("k", [1, 2])
def test_two_ranks_train_as_one_process_on_the_global_batch(runs, k):
    one_dir, (one_setup,) = runs("one", k)
    two_dir, logs = runs("two", k)
    assert one_setup == "per_host_batch 4 steps_per_epoch 2"
    for r, log in enumerate(logs):
        assert re.search(rf"\[rank {r}/2\] per_host_batch 2 steps_per_epoch 2",
                         log), log[-2000:]
    one, two = epoch_log(one_dir), epoch_log(two_dir)
    assert [e["epoch"] for e in two] == [e["epoch"] for e in one] == [0, 1]
    for a, b in zip(one, two):
        for want, got in ((a["train"], b["train"]),
                          (a["valid"]["synthetic"], b["valid"]["synthetic"])):
            for key in want:
                if key != "epoch_time_s":
                    np.testing.assert_allclose(got[key], want[key], rtol=1e-3,
                                               atol=1e-5, err_msg=key)
    _assert_params_close(params(two_dir), params(one_dir))


@pytest.mark.parametrize("k", [1, 2])
def test_only_rank_0_writes(runs, k):
    two_dir, _ = runs("two", k)
    rank1_dir = osp.join(osp.dirname(osp.dirname(two_dir)),
                         f"two_k{k}_rank1")
    assert not osp.exists(rank1_dir)
    for name in ("config.yaml", "epoch_log.jsonl", "valid_log.txt",
                 "ckpt/latest_network/state.pt",
                 "ckpt/epoch000_network/state.pt",
                 "ckpt/best_network/state.pt"):
        assert osp.exists(osp.join(two_dir, name)), name


def test_two_rank_mid_epoch_resume_is_bit_for_bit(runs, tmp_path):
    whole_dir, _ = runs("two", 1)
    d = tmp_path / "resumed"
    died = launch([d, d], 1, code=DYING)
    assert all(rc != 0 for rc, _ in died), died
    meta = json.loads((d / "run" / "ckpt" / "latest_network.meta.json")
                      .read_text())
    assert (meta["mid_epoch"], meta["step_in_epoch"]) == (0, 1)
    assert_ok(launch([d, d], 1, "resume=latest_network"))
    got, want = params(d / "run"), params(whole_dir)
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_two_rank_test_csv_is_one_process_csv(runs, tmp_path):
    """``exp_type: test`` on 2 ranks: every rank evaluates the same frames
    from the same checkpoint, rank 0 alone writes the CSV, and it is the
    bits of one process's."""
    ckpt = osp.join(runs("two", 1)[0], "ckpt")
    sets = ["exp_type=test", f"checkpoint_path={ckpt}"]
    one = main([*TINY, f"base_log_dir={tmp_path / 'one'}",
                "tpu.train_steps_per_call=1", *sets])
    assert_ok(launch([tmp_path / "two", tmp_path / "two_rank1"], 1, *sets))
    assert not (tmp_path / "two_rank1").exists()
    with open(osp.join(one.result_dir, "synthetic.csv")) as f:
        want = f.read()
    assert (tmp_path / "two" / "run" / "result" / "synthetic.csv"
            ).read_text() == want
    assert want.splitlines()[-1].startswith("MEAN,")
