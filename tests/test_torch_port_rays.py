"""The mesh's ``rays`` axis in the port (``implicit_depth_torch/parallel``)
on the CPU: ranks of a gloo process group, each a subprocess with a
timeout and ``OMP_NUM_THREADS=1``, against the JAX package on the global
batch and against the port's one process.

(a) ``mesh.layout`` against the JAX trainer's mesh rule and
``make_mesh``'s device order, over a table of (hosts, ranks a host,
batch), and the layouts JAX refuses; (b) the trainer on 4 ranks at
``batch_size: 2`` takes one step of the global batch of 2 (the port used
to train a batch of 4 there); (c) one stage-1 step at data 2 × rays 2 (4
ranks) and at data 1 × rays 3 (3 ranks, ragged blocks of 256 rays)
against ``jax.grad`` of the JAX step on the global batch; (d) both at an
epoch where the surface-normal term runs over the gathered predictions;
(e) the eval step with each frame's rays split over 4 ranks against JAX's
``ray_axis`` eval and the port's one process, one shot and chunked, and
the stage-2 eval step against the port's one process; (f) the stage-2
step at data 2 × rays 2 with hard negatives against JAX; (g) the
``global`` decode mode's step and eval under the layout against the
port's one process.

Tolerances: those of ``test_torch_port_train.py::
test_train_step_matches_jax_grad`` and of ``test_torch_port_refine_train``
(f32: losses 1e-4 and 1e-5, every gradient within 1e-4 of its largest
value), JAX's ``tests/test_parallel.py`` for the eval (``pred_pos`` atol
1e-4, ``loss_net`` rtol 1e-4); the ranks' loss shares against the port's
one process 1e-6 relative (f32 sums in another order); the eval outputs of
the ranks the bits of one process's.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from test_torch_port_parallel import (
    REPO,
    RANK_TIMEOUT_S,
    assert_ok,
    free_port,
    rank_env,
    wait_all,
)
from test_torch_port_refine_train import Case as RefineCase
from test_torch_port_refine_train import _jax_refine_step
from test_torch_port_refine_train import tiny_overrides as refine_overrides
from test_torch_port_train import (
    H,
    W,
    N,
    T,
    _both_models,
    _jax_step,
    _leaves,
    assert_rel_max,
    tiny_overrides,
)

from implicit_depth_torch.builder import build_lidf, build_refine, build_static
from implicit_depth_torch.config import load_config
from implicit_depth_torch.data.synthetic import synthetic_batch
from implicit_depth_torch.parallel import mesh
from implicit_depth_torch.train.state import TrainState
from implicit_depth_torch.train.steps import (
    make_lidf_eval_step,
    make_lidf_train_step,
    make_refine_eval_step,
    make_refine_train_step,
)
from implicit_depth_torch.weights import (
    lidf_from_jax,
    lidf_grads_from_jax,
    refine_from_jax,
    refine_grads_from_jax,
    resnet_batch_stats,
)
from implicit_depth_tpu.config import load_config as jax_load_config
from implicit_depth_tpu.parallel import mesh as jmesh
from implicit_depth_tpu.builder import build_lidf as jax_build_lidf
from implicit_depth_tpu.builder import build_static as jax_build_static
from implicit_depth_tpu.train import state as jstate
from implicit_depth_tpu.train import steps as jsteps

torch.set_num_threads(2)
BATCH = 2         # the global batch of every train case
# the global decode mode at a budget of 1 pair a ray, which drops pairs:
# the selection is the global batch's, each rank decoding its block's rows
GLOBAL = {"pairs_budget_mode": "global", "pairs_budget_per_ray": 1}
CHUNK = 500       # the chunked eval's rays a chunk (a rank holds 768)
EVAL_SEED = 61

# one rank: joins the group, takes the layout of the global batch, runs
# every job of the case file on its block of the global tensors
WORKER = r'''
import sys
import torch
torch.set_num_threads(1)
from implicit_depth_torch.builder import build_lidf, build_refine, build_static
from implicit_depth_torch.config import load_config
from implicit_depth_torch.parallel import mesh
from implicit_depth_torch.train.state import TrainState
from implicit_depth_torch.train import steps

case_path, out_path = sys.argv[1:3]
mesh.init_from_env("cpu", timeout_s=60)
case = torch.load(case_path, weights_only=False)


def rows(t):
    lay = mesh.use_layout(case["batch_size"])
    b = t.shape[0] // lay.data
    return t[lay.data_index * b:(lay.data_index + 1) * b]


def grads(model):
    return {n: p.grad for n, p in model.named_parameters()}


def stage1(job):
    cfg = load_config(overrides=job["overrides"])
    model = build_lidf(cfg, build_static(cfg))
    model.load_state_dict(job["state"])
    state = TrainState.create(model, cfg.training, steps_per_epoch=10)
    losses = steps.make_lidf_train_step(cfg, model, "cpu")(
        state, {k: rows(v) for k, v in job["batch"].items()}, None,
        job["epoch"], valid_idx=rows(job["valid_idx"]),
        miss_start=rows(job["miss_start"]))
    return {"losses": losses, "grads": grads(model),
            "state": {k: v.clone() for k, v in model.state_dict().items()}}


def stage2(job):
    cfg = load_config(overrides=job["overrides"])
    static = build_static(cfg)
    lidf, ref = build_lidf(cfg, static), build_refine(cfg, static)
    lidf.load_state_dict(job["lidf"])
    ref.load_state_dict(job["refine"])
    state = TrainState.create(ref, cfg.training, steps_per_epoch=10)
    losses = steps.make_refine_train_step(cfg, lidf, ref, "cpu")(
        state, {k: rows(v) for k, v in job["batch"].items()}, None,
        job["epoch"], valid_idx=rows(job["valid_idx"]),
        miss_start=rows(job["miss_start"]),
        noise={k: rows(v) for k, v in job["noise"].items()})
    return {"losses": losses, "grads": grads(ref)}


def evaluate(job):
    cfg = load_config(overrides=job["overrides"])
    static = build_static(cfg, n_rays=job["rays"])
    lidf = build_lidf(cfg, static)
    lidf.load_state_dict(job["lidf"])
    state = TrainState.create(lidf, cfg.training, steps_per_epoch=10)
    if "refine" not in job:
        return steps.make_lidf_eval_step(cfg, lidf, "cpu")(
            state, job["batch"], valid_idx=job["valid_idx"])[1:]
    ref = build_refine(cfg, static)
    ref.load_state_dict(job["refine"])
    state = TrainState.create(ref, cfg.training, steps_per_epoch=10)
    return steps.make_refine_eval_step(cfg, lidf, ref, "cpu")(
        state, job["batch"], valid_idx=job["valid_idx"])[2:]


def trainer(job):
    from implicit_depth_torch.main import make_trainer
    from implicit_depth_torch.train.trainer import to_device
    tr = make_trainer(job["argv"])
    batch = next(iter(tr.train_loader.epoch(0)))
    losses = tr.train_step(tr.state, to_device(batch, tr.device),
                           tr.generator, 0)
    return {"losses": losses, "grads": grads(tr.model),
            "items": batch["item_path"], "layout": getattr(tr, "layout", None)}


jobs = {"stage1": stage1, "stage2": stage2, "eval": evaluate,
        "trainer": trainer}
torch.save({name: jobs[job["kind"]](job) for name, job in case["jobs"].items()},
           out_path)
mesh.shutdown()
'''


def start_ranks(tmp_path, name, case, world):
    """WORKER on ``world`` ranks, started; :func:`finish_ranks` collects."""
    case_path = tmp_path / f"{name}_case.pt"
    torch.save(case, case_path)
    port = free_port()
    outs = [tmp_path / f"{name}_rank{r}.pt" for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(case_path), str(out)], cwd=REPO,
        env=rank_env(r, world, port), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r, out in enumerate(outs)]
    return procs, outs


def finish_ranks(started):
    procs, outs = started
    assert_ok(wait_all(procs, RANK_TIMEOUT_S))
    return [torch.load(out, weights_only=False) for out in outs]


# -- (a) the layout ------------------------------------------------------------

class _FakeDevice:
    """A device of host ``process_index`` for ``make_mesh``'s grouping."""

    def __init__(self, process_index, id_):
        self.process_index, self.id = process_index, id_


def _jax_layout(monkeypatch, hosts, local, batch):
    """{global rank: (data index, ray index)} of the JAX trainer's mesh
    (``implicit_depth_tpu/train/trainer.py:77-93``) over ``hosts`` hosts of
    ``local`` devices, device id = host · local + local index; the mesh's
    device array read from ``make_mesh``."""
    import math
    per_host = max(batch // hosts, 1)
    data_local = math.gcd(per_host, local)
    devices = [_FakeDevice(h, h * local + i) for h in range(hosts)
               for i in range(local)]
    monkeypatch.setattr(jmesh, "Mesh", lambda arr, names: arr)
    arr = jmesh.make_mesh((data_local * hosts, local // data_local),
                          ("data", "rays"), devices=devices)
    return {arr[d, r].id: (d, r) for d in range(arr.shape[0])
            for r in range(arr.shape[1])}


LAYOUTS = [(1, 4, 2), (1, 4, 4), (1, 3, 2), (1, 8, 6), (1, 8, 32),
           (1, 2, 1), (2, 4, 4), (2, 4, 2), (2, 2, 6), (4, 2, 4), (2, 3, 8),
           (2, 8, 4)]


@pytest.mark.parametrize("hosts,local,batch", LAYOUTS)
def test_layout_is_the_jax_trainers_mesh(monkeypatch, hosts, local, batch):
    want = _jax_layout(monkeypatch, hosts, local, batch)
    world = hosts * local
    lays = [mesh.layout(batch, world, local, r) for r in range(world)]
    for r, lay in enumerate(lays):
        assert (lay.data_index, lay.ray_index) == want[r], r
        assert lay.coords == lays[0].coords
    data = max(d for d, _ in want.values()) + 1
    assert (lays[0].data, lays[0].rays) == (data, world // data)


def test_layout_on_the_virtual_devices():
    """One host: ``make_mesh`` over the 8 virtual CPU devices puts device i
    where the layout puts rank i."""
    devs = jax.devices()
    assert len(devs) == 8
    for batch in (2, 4, 6, 1):
        import math
        d = math.gcd(batch, 8)
        m = jmesh.make_mesh((d, 8 // d), ("data", "rays"), devices=devs)
        for r in range(8):
            lay = mesh.layout(batch, 8, 8, r)
            assert m.devices[lay.data_index, lay.ray_index] == devs[r]


@pytest.mark.parametrize("world,local,batch,match", [
    (4, 2, 3, "multiple of the host count 2"),
    (4, 2, 1, "multiple of the host count 2"),
    (6, 4, 4, "hosts of 4 ranks"),
])
def test_layouts_jax_refuses_raise(world, local, batch, match):
    with pytest.raises(ValueError, match=match):
        mesh.layout(batch, world, local, 0)


def test_an_empty_block_of_rays_raises():
    assert [mesh.ray_block(128, 3, i) for i in range(3)] == \
        [(0, 42), (42, 85), (85, 128)]
    with pytest.raises(ValueError, match="would be empty"):
        mesh.ray_block(2, 3, 0)


def test_without_a_group_the_layout_is_one_block():
    lay = mesh.current()
    assert (lay.data, lay.rays, lay.data_index, lay.ray_index) == (1, 1, 0, 0)
    split = mesh.train_split(10)
    t = torch.arange(6.0).reshape(1, 6)
    assert split.gather(t) is t and split.bounds() == (0, 10)


# -- the rank runs: one launch of 4 ranks, one of 3 ---------------------------------

TRAIN_ARGV = ["--device", "cpu", "--cfg_paths",
              str(REPO / "configs" / "smoke_synthetic.yaml"), "--set",
              "log_name=run", "resume=None", "dataset.img_width=64",
              "dataset.img_height=48", "dataset.synthetic_len=4",
              "grid.miss_sample_num=256", "grid.valid_sample_num=256",
              "tpu.max_pairs_per_ray=12", "tpu.pairs_budget_per_ray=8",
              "tpu.compute_dtype=float32", "model.rgb_out=8",
              "model.pnet_out=16", "model.pnet_gf=8", "model.imnet_gf=8",
              "model.resnet_stages=[1, 1, 1, 1]",
              f"training.batch_size={BATCH}", "training.nepochs=1"]


class Stage1:
    """The stage-1 models of both frameworks (``_both_models``: the
    weights randomized, a batch of 2) and JAX's step at each epoch."""

    def __init__(self):
        (self.jcfg, self.jstatic, self.jmodel, self.var, self.raw, self.cfg,
         self.model) = _both_models("float32")
        self.jax = {}

    def overrides(self, mode=None):
        over = tiny_overrides("float32")
        if mode:
            over["tpu"] = {**over["tpu"], **mode}
        return over

    def job(self, epoch, mode=None):
        jin, *_ = self.step(epoch)
        return {"kind": "stage1", "overrides": self.overrides(mode),
                "epoch": epoch,
                "state": {k: v.clone()
                          for k, v in self.model.state_dict().items()},
                "batch": {k: T(v) for k, v in self.raw.items()},
                "valid_idx": T(jin["valid_idx"]),
                "miss_start": T(jin["miss_start"])}

    def step(self, epoch):
        if epoch not in self.jax:
            self.jax[epoch] = _jax_step(self.jcfg, self.jstatic, self.jmodel,
                                        self.var, self.raw, epoch)
        return self.jax[epoch]


def _hardneg_overrides():
    return {**refine_overrides("float32"),
            "loss": {"surf_norm_epo": 5, "hard_neg": True,
                     "hard_neg_ratio": 0.1}}


class Stage2:
    """The stage-2 case of test_torch_port_refine_train with the
    hard-negative loss, and JAX's step at epoch 10."""

    def __init__(self):
        self.c = RefineCase("float32")
        self.c.jcfg = jax_load_config(overrides=_hardneg_overrides())
        self.c.cfg = load_config(overrides=_hardneg_overrides())
        self.jin, self.jgrads, self.jlosses, self.noise = _jax_refine_step(
            self.c, 10)

    def job(self):
        lidf, ref = self.c.port_models()
        return {"kind": "stage2", "overrides": _hardneg_overrides(),
                "epoch": 10, "lidf": lidf.state_dict(),
                "refine": ref.state_dict(), "batch": self.c.tbatch(),
                "valid_idx": T(self.jin["valid_idx"]),
                "miss_start": T(self.jin["miss_start"]),
                "noise": {k: T(v) for k, v in self.noise.items()}}


def _eval_overrides(chunk=0, mode=None):
    return {**refine_overrides("float32"),
            "tpu": {**refine_overrides("float32")["tpu"],
                    "eval_rays_per_chunk": chunk, **(mode or {})}}


class Eval:
    """A frame, the stage-1 weights of ``stage1`` and the stage-2 weights
    of ``stage2`` at the frame's ray count; JAX's eval step of the frame
    under a (1, 8) ray mesh (``tests/test_parallel.py:81``'s case)."""

    def __init__(self, stage1, stage2):
        self.raw = synthetic_batch(EVAL_SEED, 1, H, W)
        self.var = stage1.var
        self.refine = stage2.c.port_models()[1].state_dict()
        jcfg = jax_load_config(overrides=_eval_overrides())
        jl = jax_build_lidf(jcfg, jax_build_static(jcfg, n_rays=H * W))
        st = jstate.TrainState.create(self.var["params"],
                                      self.var["batch_stats"],
                                      jstate.make_optimizer("adam", 1e-3))
        ray_mesh = Mesh(np.asarray(jax.devices()).reshape(1, 8),
                        ("data", "rays"))
        with jax.set_mesh(ray_mesh):
            self.jin, self.jout, self.jlosses = jsteps.make_lidf_eval_step(
                jcfg, jl, ray_axis="rays")(
                st, {k: jnp.asarray(v) for k, v in self.raw.items()},
                jax.random.key(3))

    def models(self, chunk=0, mode=None):
        cfg = load_config(overrides=_eval_overrides(chunk, mode))
        static = build_static(cfg, n_rays=H * W)
        lidf = lidf_from_jax(self.var, build_lidf(cfg, static))
        ref = build_refine(cfg, static)
        ref.load_state_dict(self.refine)
        return cfg, lidf, ref

    def job(self, chunk=0, refine=False, mode=None):
        job = {"kind": "eval", "overrides": _eval_overrides(chunk, mode),
               "rays": H * W, "lidf": self.models()[1].state_dict(),
               "batch": {k: T(v) for k, v in self.raw.items()},
               "valid_idx": T(self.jin["valid_idx"])}
        if refine:
            job["refine"] = self.refine
        return job

    def one_process(self, refine=False, mode=None):
        """The eval step in this process, at the ranks' one thread: the
        CPU convolutions' bits depend on the thread count."""
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            return self._one_process(refine, mode)
        finally:
            torch.set_num_threads(threads)

    def _one_process(self, refine, mode):
        cfg, lidf, ref = self.models(mode=mode)
        batch = {k: T(v) for k, v in self.raw.items()}
        vidx = T(self.jin["valid_idx"])
        if not refine:
            state = TrainState.create(lidf, cfg.training, steps_per_epoch=10)
            return make_lidf_eval_step(cfg, lidf, "cpu")(
                state, batch, valid_idx=vidx)[1:]
        state = TrainState.create(ref, cfg.training, steps_per_epoch=10)
        return make_refine_eval_step(cfg, lidf, ref, "cpu")(
            state, batch, valid_idx=vidx)[2:]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every rank job, the ranks started first and the JAX references
    computed while they run: on 4 ranks (data 2 × rays 2 for training;
    every eval frame's rays over all 4) the trainer's first step, the
    stage-1 step at epochs 0 and 10, the stage-2 step, the eval steps; on
    3 ranks (data 1 × rays 3) the stage-1 step at epoch 10."""
    tmp = tmp_path_factory.mktemp("rays")
    s1 = Stage1()
    s2 = Stage2()
    ev = Eval(s1, s2)
    four = start_ranks(tmp, "four", {"batch_size": BATCH, "jobs": {
        "stage1_e0": s1.job(0), "stage1_e10": s1.job(10),
        "stage2": s2.job(),
        "eval": ev.job(), "eval_chunked": ev.job(CHUNK),
        "eval_refine": ev.job(refine=True),
        "stage1_global": s1.job(10, GLOBAL), "eval_global": ev.job(
            mode=GLOBAL)}}, 4)
    three = start_ranks(tmp, "three", {"batch_size": BATCH, "jobs": {
        "stage1_e10": s1.job(10)}}, 3)
    return {"s1": s1, "s2": s2, "eval": ev, "four": finish_ranks(four),
            "three": finish_ranks(three)}


# -- (b) the trainer's global batch on 4 ranks at batch 2 ------------------------

def test_four_ranks_at_batch_2_step_on_the_global_batch_of_2(tmp_path):
    """The trainer built by the CLI on 4 ranks at ``batch_size: 2``: each
    rank loads its data block (1 image, the same for both ranks of a rays
    group: 2 images in all, not 4), and the first step's summed losses and
    gradients are those of one process on the global batch of 2."""
    from implicit_depth_torch.main import make_trainer
    from implicit_depth_torch.train.trainer import to_device
    ranks = [rk["trainer"] for rk in finish_ranks(start_ranks(
        tmp_path, "trainer", {"batch_size": BATCH, "jobs": {"trainer": {
            "kind": "trainer",
            "argv": [*TRAIN_ARGV, f"base_log_dir={tmp_path / 'ranks'}"]}}},
        4))]
    items = [r["items"] for r in ranks]
    assert items[0] == items[1] and items[2] == items[3], items
    assert [(r["layout"].data, r["layout"].rays) for r in ranks] == \
        [(2, 2)] * 4
    assert [(r["layout"].data_index, r["layout"].ray_index)
            for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    tr = make_trainer([*TRAIN_ARGV, f"base_log_dir={tmp_path / 'one'}"])
    batch = next(iter(tr.train_loader.epoch(0)))
    assert batch["item_path"] == items[0] + items[2]
    losses = tr.train_step(tr.state, to_device(batch, tr.device),
                           tr.generator, 0)
    for k, v in losses.items():
        np.testing.assert_allclose(sum(N(r["losses"][k]) for r in ranks),
                                   N(v), rtol=1e-5, atol=1e-7, err_msg=k)
    for name, p in tr.model.named_parameters():
        # after the step's all-reduce every rank holds the summed gradient
        assert_rel_max(N(ranks[0]["grads"][name]), N(p.grad), 1e-4, name,
                       atol=1e-7)


# -- (c), (d) the stage-1 step against jax.grad ------------------------------------

STAGE1_CASES = [("four", "stage1_e0", 0), ("four", "stage1_e10", 10),
                ("three", "stage1_e10", 10)]


@pytest.mark.parametrize("launch,job,epoch", STAGE1_CASES)
def test_stage1_step_on_a_rays_layout_matches_jax_grad(runs, launch, job,
                                                       epoch):
    """f32: losses 1e-4, every gradient within 1e-4 of its largest value
    (plus 1e-7), the batch statistics 1e-4; the ranks' shares sum to the
    port's one-process losses within 1e-6 relative; every rank the same
    gradients, parameters and statistics, bit for bit. The surface-normal
    term runs at both epochs (``surf_norm_epo`` 0), over every block's
    predictions."""
    s1 = runs["s1"]
    jin, jgrads, jlosses, jstats = s1.step(epoch)
    ranks = [rk[job] for rk in runs[launch]]
    model = build_lidf(s1.cfg, build_static(s1.cfg))
    model.load_state_dict(s1.job(epoch)["state"])
    state = TrainState.create(model, s1.cfg.training, steps_per_epoch=10)
    one = make_lidf_train_step(s1.cfg, model, "cpu")(
        state, {k: T(v) for k, v in s1.raw.items()}, None, epoch,
        valid_idx=T(jin["valid_idx"]), miss_start=T(jin["miss_start"]))
    assert float(one["surf_norm_loss"]) > 0
    for k in jlosses:
        got = sum(N(r["losses"][k]) for r in ranks)
        np.testing.assert_allclose(got, np.asarray(jlosses[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
        np.testing.assert_allclose(got, N(one[k]), rtol=1e-6, atol=1e-9,
                                   err_msg=k)
    for r in ranks[1:]:
        for k in r["grads"]:
            assert torch.equal(r["grads"][k], ranks[0]["grads"][k]), k
        for k in r["state"]:
            assert torch.equal(r["state"][k], ranks[0]["state"][k]), k
    want = lidf_grads_from_jax(jgrads, s1.model)
    for name, g in ranks[0]["grads"].items():
        assert_rel_max(N(g), N(want[name]), 1e-4, name, atol=1e-7)
    model.load_state_dict(ranks[0]["state"])
    got_stats = resnet_batch_stats(model.resnet)
    for path, node in _leaves(jstats["resnet"]):
        g = got_stats
        for key in path:
            g = g[key]
        assert_rel_max(g, node, 1e-4, "/".join(path))


# -- (e) the eval steps, each frame's rays over 4 ranks ------------------------

@pytest.mark.parametrize("job", ["eval", "eval_chunked"])
def test_ray_split_eval_matches_jax_and_one_process(runs, job):
    ev = runs["eval"]
    out0, losses0 = ev.one_process()
    for rk in runs["four"]:
        out, _ = rk[job]
        np.testing.assert_allclose(N(out["pred_pos"]),
                                   np.asarray(ev.jout["pred_pos"]), atol=1e-4)
        # the port's one process: every gathered output the same bits
        assert set(out) == set(out0)
        for k in out0:
            assert torch.equal(out[k], out0[k]), k
    np.testing.assert_allclose(
        sum(N(rk[job][1]["loss_net"]) for rk in runs["four"]),
        float(ev.jlosses["loss_net"]), rtol=1e-4)
    for k in losses0:
        np.testing.assert_allclose(
            sum(N(rk[job][1][k]) for rk in runs["four"]), N(losses0[k]),
            rtol=1e-6, atol=1e-9, err_msg=k)


def test_ray_split_refine_eval_is_one_process(runs):
    """The stage-2 eval step: the frozen stage 1 on each rank's block, its
    outputs gathered, the RefineNet's rows (K4) of the block; the refined
    positions the bits of one process's, the losses' shares its losses."""
    ev = runs["eval"]
    pred0, losses0 = ev.one_process(refine=True)
    for rk in runs["four"]:
        pred, _ = rk["eval_refine"]
        assert torch.equal(pred, pred0)
    for k in losses0:
        np.testing.assert_allclose(
            sum(N(rk["eval_refine"][1][k]) for rk in runs["four"]),
            N(losses0[k]), rtol=1e-6, atol=1e-9, err_msg=k)


# -- (f) the stage-2 step with hard negatives ---------------------------------------

def test_stage2_hardneg_step_on_a_rays_layout_matches_jax_grad(runs):
    """data 2 × rays 2: the frozen stage 1 decodes each rank's block, the
    RefineNet's PointNet takes every point of the gathered predictions,
    the hard-negative top-k is the global batch's. f32: losses 1e-5, every
    refine gradient within 1e-4 of its largest value (plus 1e-7)."""
    s2 = runs["s2"]
    ranks = [rk["stage2"] for rk in runs["four"]]
    for k in s2.jlosses:
        np.testing.assert_allclose(sum(N(r["losses"][k]) for r in ranks),
                                   np.asarray(s2.jlosses[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    _, ref = s2.c.port_models()
    want = refine_grads_from_jax(s2.jgrads, ref)
    for r in ranks[1:]:
        for k in r["grads"]:
            assert torch.equal(r["grads"][k], ranks[0]["grads"][k]), k
    for name, g in ranks[0]["grads"].items():
        assert_rel_max(N(g), N(want[name]), 1e-4, name, atol=1e-7)


# -- the global decode mode under the layout --------------------------------------

def test_global_mode_on_a_rays_layout_is_one_process(runs):
    """``pairs_budget_mode: global`` at a budget of 1 pair a ray: the
    selection is the global batch's (the data blocks' pair slots gathered
    in a train step), each rank decoding the selected rows of its block.
    The stage-1 step at data 2 × rays 2 and the eval over 4 ranks against
    the port's one process (whose global decode the pair-decode tests hold
    against JAX): losses 1e-5 relative, gradients within 1e-4 of their
    largest value, eval outputs 1e-6 (the plain decode of the rows in
    another order)."""
    s1, ev = runs["s1"], runs["eval"]
    cfg = load_config(overrides=s1.overrides(GLOBAL))
    model = build_lidf(cfg, build_static(cfg))
    assert model.decode_mode == "global"
    model.load_state_dict(s1.job(10)["state"])
    jin, *_ = s1.step(10)
    one = make_lidf_train_step(cfg, model, "cpu")(
        TrainState.create(model, cfg.training, steps_per_epoch=10),
        {k: T(v) for k, v in s1.raw.items()}, None, 10,
        valid_idx=T(jin["valid_idx"]), miss_start=T(jin["miss_start"]))
    ranks = [rk["stage1_global"] for rk in runs["four"]]
    for k, v in one.items():
        np.testing.assert_allclose(sum(N(r["losses"][k]) for r in ranks),
                                   N(v), rtol=1e-5, atol=1e-8, err_msg=k)
    for name, p in model.named_parameters():
        assert_rel_max(N(ranks[0]["grads"][name]), N(p.grad), 1e-4, name,
                       atol=1e-7)
    out0, losses0 = ev.one_process(mode=GLOBAL)
    for rk in runs["four"]:
        out, _ = rk["eval_global"]
        for k in out0:
            np.testing.assert_allclose(N(out[k]), N(out0[k]), atol=1e-6,
                                       rtol=0, err_msg=k)
    for k in losses0:
        np.testing.assert_allclose(
            sum(N(rk["eval_global"][1][k]) for rk in runs["four"]),
            N(losses0[k]), rtol=1e-5, atol=1e-8, err_msg=k)
