"""The port's data-parallel runtime (``implicit_depth_torch/parallel``) on
the CPU: two ranks of a gloo process group, each a subprocess with a
timeout, against one process on the global batch.

(a) the global hard-negative mean against the JAX package's
``hard_neg_mean`` on the global array, uneven masks and ties at the k-th
value included, and its summed gradient against ``jax.grad``; (b) the
train-mode BatchNorm against one process on the concatenated batch; (c)
the stage-1 and stage-2 losses: the ranks' shares sum to the global loss,
their gradients to its gradient; (d) one f32 stage-1 step of two ranks
against ``jax.grad`` of the JAX step on the global batch, at the limits
of ``test_torch_port_train.py::test_train_step_matches_jax_grad``; (e) the
CLI run as two processes against one (``test_torch_port_parallel_cli.py``).

Tolerances: f32 sums taken in another order (the ranks' partial sums
added by the all-reduce), 1e-6 relative for single reductions.
"""

import itertools
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_train import (
    KB,
    N,
    T,
    _both_models,
    _jax_step,
    _leaves,
    assert_rel_max,
    tiny_overrides,
)

from implicit_depth_torch.builder import build_static
from implicit_depth_torch.config import load_config
from implicit_depth_torch.data.synthetic import synthetic_batch
from implicit_depth_torch.models import lidf
from implicit_depth_torch.models.refine import refine_loss
from implicit_depth_torch.models.resnet import _bn_f32
from implicit_depth_torch.ops.masked import masked_softmax
from implicit_depth_torch.parallel import mesh
from implicit_depth_torch.weights import lidf_grads_from_jax, resnet_batch_stats
from implicit_depth_tpu.models import lidf as jlidf

REPO = Path(__file__).resolve().parent.parent
WORLD = 2
RANK_TIMEOUT_S = 120
torch.set_num_threads(2)

# one rank: joins the group from torchrun's variables, runs the job named
# in argv on its rows of the case file's global tensors, saves its results
WORKER = r'''
import sys
import torch
torch.set_num_threads(1)
from implicit_depth_torch.parallel import mesh

job, case_path, out_path = sys.argv[1:4]
mesh.init_from_env("cpu", timeout_s=60)
case = torch.load(case_path, weights_only=False)
r, world = mesh.rank(), mesh.world()


def rows(t):
    b = t.shape[0] // world
    return t[r * b:(r + 1) * b]


def leaf(t):
    return rows(t).clone().requires_grad_(True)


def hardneg():
    from implicit_depth_torch.parallel.hardneg import sharded_hard_neg_mean
    out = []
    for x, m, ratio in case["cases"]:
        xl = leaf(x)
        share = sharded_hard_neg_mean(xl, rows(m), ratio)
        share.backward()
        out.append((share.detach(), xl.grad))
    return out


def bn():
    from implicit_depth_torch.models.resnet import _bn_f32
    m = torch.nn.BatchNorm2d(case["x"].shape[1])
    m.load_state_dict(case["bn"])
    x = leaf(case["x"])
    y = _bn_f32(x, m.train())
    (y * rows(case["cot"])).sum().backward()
    return {"y": y.detach(), "dx": x.grad, "dw": m.weight.grad,
            "db": m.bias.grad, "mean": m.running_mean, "var": m.running_var}


def loss():
    from implicit_depth_torch.models.lidf import lidf_loss
    from implicit_depth_torch.models.refine import refine_loss
    inputs = {k: rows(v) for k, v in case["inputs"].items()}
    out = {}
    for hard_neg in (False, True):
        kw = dict(case["kw"], hard_neg=hard_neg, sharded=True)
        pred, logit = leaf(case["pred_pos"]), leaf(case["prob_logit"])
        got = lidf_loss(inputs, {"pred_pos": pred, "prob_logit": logit,
                                 "pair_valid": rows(case["pair_valid"]),
                                 "prob_softmax": rows(case["prob_softmax"])},
                        **kw)
        got["loss_net"].backward()
        out[("lidf", hard_neg)] = ({k: v.detach() for k, v in got.items()},
                                   [pred.grad, logit.grad])
        del kw["prob_w"]
        pred = leaf(case["pred_pos"])
        got = refine_loss(inputs, pred, **kw)
        got["loss_net"].backward()
        out[("refine", hard_neg)] = ({k: v.detach() for k, v in got.items()},
                                     [pred.grad])
    return out


def step():
    from implicit_depth_torch.builder import build_lidf, build_static
    from implicit_depth_torch.config import load_config
    from implicit_depth_torch.train.state import TrainState
    from implicit_depth_torch.train.steps import make_lidf_train_step
    cfg = load_config(overrides=case["overrides"])
    model = build_lidf(cfg, build_static(cfg))
    model.load_state_dict(case["state"])
    state = TrainState.create(model, cfg.training, steps_per_epoch=10)
    losses = make_lidf_train_step(cfg, model, "cpu")(
        state, {k: rows(v) for k, v in case["batch"].items()}, None,
        case["epoch"], valid_idx=rows(case["valid_idx"]),
        miss_start=rows(case["miss_start"]))
    return {"losses": losses,
            "grads": {n: p.grad for n, p in model.named_parameters()},
            "state": {k: v.clone() for k, v in model.state_dict().items()}}


torch.save({"hardneg": hardneg, "bn": bn, "loss": loss, "step": step}[job](),
           out_path)
mesh.shutdown()
'''


# rank 0's store ports: below the kernel's ephemeral range (32768 up on
# Linux), so that no socket of another process (a gloo pair, a store
# client) is handed one between free_port() and rank 0's bind, and a block
# of them for each xdist worker, so that two workers' tests never share
# one. Ports handed out by the kernel (bind to port 0) raced: another
# worker's rank could take the port first, and a rank then joined the
# wrong group, hung or aborted.
PORT_BASE, PORTS_PER_WORKER = 20000, 200
_NEXT_PORT = itertools.count()


def free_port():
    """A port for a launch's store, free now, that no other xdist worker of
    this test run is handed and no earlier launch of this worker used."""
    worker = os.environ.get("PYTEST_XDIST_WORKER", "gw0")
    index = int(worker[2:]) if worker[2:].isdigit() else 0
    first = PORT_BASE + index * PORTS_PER_WORKER
    for _ in range(PORTS_PER_WORKER):
        port = first + next(_NEXT_PORT) % PORTS_PER_WORKER
        with socket.socket() as s:
            try:
                s.bind(("localhost", port))
            except OSError:
                continue
        return port
    raise RuntimeError(f"no free port in {first}..{first + PORTS_PER_WORKER}")


def rank_env(rank, world, port, **extra):
    """This process's environment with torchrun's variables of ``rank``."""
    return dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                MASTER_PORT=str(port), OMP_NUM_THREADS="1", **extra)


def wait_all(procs, timeout=RANK_TIMEOUT_S):
    """Each process's (return code, output), after all exit; at
    ``timeout`` every one still running is killed and the test fails."""
    done = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            done.append((p.returncode, out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return done


def assert_ok(done):
    for rc, out in done:
        assert rc == 0, f"rank failed ({rc}):\n{out[-4000:]}"
    return [out for _, out in done]


def run_ranks(tmp_path, job, case, world=WORLD):
    """``job`` of WORKER on ``world`` ranks; each rank's results."""
    case_path = tmp_path / f"{job}_case.pt"
    torch.save(case, case_path)
    port = free_port()
    outs = [tmp_path / f"{job}_rank{r}.pt" for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, job, str(case_path), str(out)],
        cwd=REPO, env=rank_env(r, world, port), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r, out in enumerate(outs)]
    assert_ok(wait_all(procs))
    return [torch.load(out, weights_only=False) for out in outs]


def test_without_a_group_every_collective_is_a_no_op():
    assert (mesh.rank(), mesh.world(), mesh.is_main(), mesh.shard()) == \
        (0, 1, True, (0, 1))
    t = torch.arange(4.0)
    assert mesh.all_reduce_sum(t) is t
    assert torch.equal(mesh.all_gather(t), t[None])
    p = torch.nn.Parameter(torch.ones(3))
    p.grad = torch.arange(3.0)
    mesh.all_reduce_grads([p])
    assert torch.equal(p.grad, torch.arange(3.0))
    mesh.replicate_state(torch.nn.Linear(2, 2), generator=torch.Generator())
    mesh.barrier()
    assert mesh.init_from_env("cpu") == "cpu"
    assert mesh.init_from_env() == "cuda"


@pytest.mark.parametrize("device,backend,cards,match", [
    ("cuda:0", "gloo", 0, "no CUDA device"),
    (None, None, 0, "no CUDA device"),
    (None, "nccl", 1, "maps to cuda:1"),   # LOCAL_RANK 1 on one card
    ("cpu", "nccl", 0, "needs a CUDA device"),
    ("cpu", "mpi", 0, "one of")])
def test_init_from_env_refuses(monkeypatch, device, backend, cards, match):
    """No fallback: a card asked for without one, a rank past the cards,
    NCCL on the CPU and an unknown backend raise before any rendezvous."""
    for k, v in dict(RANK="1", WORLD_SIZE="2", LOCAL_RANK="1",
                     MASTER_ADDR="localhost", MASTER_PORT="1").items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    with pytest.raises((RuntimeError, ValueError), match=match):
        mesh.init_from_env(device, backend)


# -- (a) hard negatives over the global batch ------------------------------------

def _hardneg_cases():
    """(x, mask, ratio) of the global (8, 50) array, rank r holding rows
    [4r, 4r + 4): uneven masks, ties at the k-th value, one rank holding
    the whole top-k, fewer finite values than k, k = 1."""
    rng = np.random.default_rng(40)
    shape = (8, 50)

    def uneven(p0, p1):
        return np.concatenate([rng.random((4, 50)) < p0,
                               rng.random((4, 50)) < p1])

    x = rng.normal(size=shape).astype(np.float32)
    tied = np.round(rng.normal(size=shape) * 2) / 2   # many values tie
    skew = tied.copy()
    skew[:4] += 10.0                                  # rank 0 holds the top
    return {
        "uneven": (x, uneven(0.8, 0.3), 0.1),
        "ties": (tied.astype(np.float32), uneven(0.7, 0.5), 0.1),
        "ties_one_rank": (skew.astype(np.float32), uneven(0.9, 0.6), 0.3),
        "fewer_than_k": (x, uneven(0.08, 0.02), 0.1),
        "k_is_1": (tied.astype(np.float32), uneven(0.5, 0.5), 0.001),
    }


HARDNEG = _hardneg_cases()


@pytest.fixture(scope="module")
def hardneg_run(tmp_path_factory):
    case = {"cases": [(T(x), T(m), ratio) for x, m, ratio in HARDNEG.values()]}
    ranks = run_ranks(tmp_path_factory.mktemp("hardneg"), "hardneg", case)
    return dict(zip(HARDNEG, zip(*ranks)))


@pytest.mark.parametrize("name", list(HARDNEG))
def test_sharded_hard_neg_mean_is_jax_on_the_global_array(hardneg_run, name):
    x, m, ratio = HARDNEG[name]
    flat = np.where(m, x, -np.inf).reshape(-1)
    k = max(int(flat.size * ratio), 1)
    kth = np.sort(flat)[::-1][k - 1]
    if name == "ties":  # the k-th value ties in both ranks' rows
        assert (flat[:200] == kth).any() and (flat[200:] == kth).any()
    if name == "ties_one_rank":
        # rank 0 holds the top-k and more values at the k-th than k needs:
        # its candidates cut its ties short
        assert (flat[200:] >= kth).sum() == 0
        assert (flat[:200] >= kth).sum() > k and (flat == kth).sum() > 1
    if name == "fewer_than_k":
        assert not np.isfinite(kth)
    want, want_grad = jax.value_and_grad(
        lambda v: jlidf.hard_neg_mean(v, jnp.asarray(m), ratio))(
            jnp.asarray(x))
    shares = [N(s) for s, _ in hardneg_run[name]]
    np.testing.assert_allclose(sum(shares), np.asarray(want), rtol=1e-6)
    # each rank's gradient reaches its own rows only: together, JAX's
    # (ties filled in global index order, as jax.lax.top_k fills them)
    grad = np.concatenate([N(g) for _, g in hardneg_run[name]])
    np.testing.assert_allclose(grad, np.asarray(want_grad), rtol=1e-6,
                               atol=1e-9)
    if not np.isfinite(kth) or (flat == kth).sum() == 1:
        # no tie: also 1-process autograd of the port's own hard_neg_mean
        xt = T(x).requires_grad_(True)
        lidf.hard_neg_mean(xt, T(m), ratio).backward()
        np.testing.assert_allclose(grad, N(xt.grad), rtol=1e-6, atol=1e-9)


# -- (b) BatchNorm over the global batch --------------------------------------------

@pytest.fixture(scope="module")
def bn_case():
    rng = np.random.default_rng(41)
    c = 6
    bn = torch.nn.BatchNorm2d(c)
    with torch.no_grad():
        bn.weight.copy_(T(1 + 0.1 * rng.normal(size=c)))
        bn.bias.copy_(T(0.1 * rng.normal(size=c)))
        bn.running_mean.copy_(T(0.1 * rng.normal(size=c)))
        bn.running_var.copy_(T(1 + 0.1 * rng.random(c)))
    x = (rng.normal(size=(4, c, 5, 7)) * rng.uniform(0.5, 2, (1, c, 1, 1))
         + rng.normal(size=(1, c, 1, 1))).astype(np.float32)
    cot = rng.normal(size=x.shape).astype(np.float32)
    return {"bn": {k: v.clone() for k, v in bn.state_dict().items()},
            "x": T(x), "cot": T(cot)}


def test_bn_over_two_ranks_is_one_process_on_the_global_batch(tmp_path,
                                                              bn_case):
    ranks = run_ranks(tmp_path, "bn", bn_case)
    m = torch.nn.BatchNorm2d(bn_case["x"].shape[1])
    m.load_state_dict(bn_case["bn"])
    x = bn_case["x"].clone().requires_grad_(True)
    y = _bn_f32(x, m.train())
    (y * bn_case["cot"]).sum().backward()

    def close(got, want, what):
        np.testing.assert_allclose(N(got), N(want), rtol=1e-6, atol=1e-6,
                                   err_msg=what)

    close(torch.cat([r["y"] for r in ranks]), y, "outputs")
    close(torch.cat([r["dx"] for r in ranks]), x.grad, "input gradients")
    close(sum(r["dw"] for r in ranks), m.weight.grad, "weight gradient")
    close(sum(r["db"] for r in ranks), m.bias.grad, "bias gradient")
    for r in ranks:  # the same statistics on every rank
        assert torch.equal(r["mean"], ranks[0]["mean"])
        assert torch.equal(r["var"], ranks[0]["var"])
        close(r["mean"], m.running_mean, "running mean")
        close(r["var"], m.running_var, "running variance")


# -- (c) the losses' shares -------------------------------------------------------

@pytest.fixture(scope="module")
def loss_run(tmp_path_factory):
    """Training inputs of 4 synthetic frames (uneven miss-pixel counts),
    random stage-1 outputs; each rank's losses and gradients."""
    cfg = load_config(overrides=tiny_overrides("float32"))
    raw = synthetic_batch(6, 4, cfg.dataset.img_height, cfg.dataset.img_width)
    inputs = lidf.prepare_inputs(build_static(cfg),
                                 {k: T(v) for k, v in raw.items()},
                                 train=True,
                                 generator=torch.Generator().manual_seed(3))
    rng = np.random.default_rng(42)
    b, r, _ = inputs["pair_valid"].shape
    pair_valid = inputs["pair_valid"][..., :KB]
    logit = T(rng.normal(size=(b, r, KB)).astype(np.float32))
    case = {
        "inputs": inputs,
        "pred_pos": inputs["gt_pos"] + T(
            0.05 * rng.normal(size=(b, r, 3)).astype(np.float32)),
        "prob_logit": logit, "pair_valid": pair_valid,
        "prob_softmax": masked_softmax(logit, pair_valid),
        "kw": dict(train=True, img_hw=(cfg.dataset.img_height,
                                       cfg.dataset.img_width),
                   pos_w=100.0, prob_w=0.5, surf_norm_w=10.0, smooth_w=1.0,
                   hard_neg_ratio=0.1),
    }
    counts = inputs["miss_slot"].sum(1)
    assert counts[:2].sum() != counts[2:].sum()  # the ranks' counts differ
    ranks = run_ranks(tmp_path_factory.mktemp("loss"), "loss", case)
    return case, ranks


@pytest.mark.parametrize("hard_neg", [False, True])
@pytest.mark.parametrize("which", ["lidf", "refine"])
def test_loss_shares_sum_to_the_global_loss(loss_run, which, hard_neg):
    case, ranks = loss_run
    kw = dict(case["kw"], hard_neg=hard_neg)
    leaves = [case["pred_pos"].clone().requires_grad_(True)]
    if which == "lidf":
        leaves.append(case["prob_logit"].clone().requires_grad_(True))
        want = lidf.lidf_loss(case["inputs"], {
            "pred_pos": leaves[0], "prob_logit": leaves[1],
            "pair_valid": case["pair_valid"],
            "prob_softmax": case["prob_softmax"]}, **kw)
    else:
        del kw["prob_w"]
        want = refine_loss(case["inputs"], leaves[0], **kw)
    want["loss_net"].backward()
    got = [rk[(which, hard_neg)] for rk in ranks]
    assert set(got[0][0]) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(sum(N(g[0][k]) for g in got), N(v),
                                   rtol=1e-6, atol=1e-9, err_msg=k)
    for i, leaf in enumerate(leaves):
        np.testing.assert_allclose(
            np.concatenate([N(g[1][i]) for g in got]), N(leaf.grad),
            rtol=1e-5, atol=1e-9)


# -- (d) one stage-1 step on two ranks against jax.grad ------------------------

@pytest.mark.parametrize("epoch", [0, 10])
def test_two_rank_step_matches_jax_grad_on_the_global_batch(tmp_path, epoch):
    """The limits of test_train_step_matches_jax_grad (f32): losses 1e-4,
    every gradient within 1e-4 of its largest value (plus 1e-7), the batch
    statistics 1e-4; and every rank holds the same gradients, parameters
    and statistics, bit for bit."""
    jcfg, jstatic, jmodel, var, raw, cfg, model = _both_models("float32")
    jin, jgrads, jlosses, jstats = _jax_step(jcfg, jstatic, jmodel, var,
                                             raw, epoch)
    case = {"overrides": tiny_overrides("float32"), "epoch": epoch,
            "state": {k: v.clone() for k, v in model.state_dict().items()},
            "batch": {k: T(v) for k, v in raw.items()},
            "valid_idx": T(jin["valid_idx"]),
            "miss_start": T(jin["miss_start"])}
    ranks = run_ranks(tmp_path, "step", case)
    for k in jlosses:
        np.testing.assert_allclose(sum(N(r["losses"][k]) for r in ranks),
                                   np.asarray(jlosses[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    for r in ranks[1:]:
        for k in r["grads"]:
            assert torch.equal(r["grads"][k], ranks[0]["grads"][k]), k
        for k in r["state"]:
            assert torch.equal(r["state"][k], ranks[0]["state"][k]), k
    want = lidf_grads_from_jax(jgrads, model)
    for name, g in ranks[0]["grads"].items():
        assert_rel_max(N(g), N(want[name]), 1e-4, name, atol=1e-7)
    model.load_state_dict(ranks[0]["state"])
    got_stats = resnet_batch_stats(model.resnet)
    for path, node in _leaves(jstats["resnet"]):
        g = got_stats
        for key in path:
            g = g[key]
        assert_rel_max(g, node, 1e-4, "/".join(path))
