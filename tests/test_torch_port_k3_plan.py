"""The host-side arithmetic of K3 (``ops/ray_decode.py::bwd_plan``), on the
CPU: the chunks of rays, the operand streams, Pass B's split-K products and
the reductions that lay the weight gradients out.

The CUDA passes run only on the card (``test_torch_port_cuda.py``). Here a
numpy emulation of Pass B and of the reductions, driven by nothing but the
plan, must reproduce each weight gradient as the plain product of its
operands over all rows, and the reductions must cover every element of the
output exactly once. The JAX package has no counterpart of this arithmetic:
its kernel keeps the weight gradients in VMEM across a sequential grid.
"""

import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from implicit_depth_torch.ops import decode_common as common
from implicit_depth_torch.ops import ray_decode as rd

KP, CRP = 240, 160  # the default model's layer-1 operand rows (c_vox 128)
# d_vox_table at the training shapes: batch 4 of 9^3 cells, c_vox 128
TABLE = 4 * 729 * 128
ROOT = Path(__file__).resolve().parents[1]


def _grad_shapes(kp, crp):
    w32 = {"pair_w1": (kp, 512), "ray_w1": (crp, 512), "b1": (512,),
           "a_vec": (256,), "c_vec": (256,)}
    for p in ("off", "prob"):
        w32.update({f"{p}_w2": (256, 128), f"{p}_b2": (128,),
                    f"{p}_w3": (128, 64), f"{p}_b3": (64,),
                    f"{p}_w4": (64,), f"{p}_b4": (1,)})
    return w32


@pytest.mark.parametrize("kp,crp", [(KP, CRP), (64, 32)])
def test_grad_layout_is_the_operand_layout(kp, crp):
    """One region per operand, in K1's operand order, at 64-float
    boundaries, of the operand's shape; regions do not overlap."""
    lay = rd.bwd_grad_layout(kp, crp)
    shapes = _grad_shapes(kp, crp)
    assert list(lay)[:-1] == list(rd.FORMAT.operands)
    end = 0
    for k in rd.FORMAT.operands:
        off, shape = lay[k]
        assert shape == shapes[k] and off % 64 == 0 and off >= end, k
        end = off + math.prod(shape)
    assert lay["total"][0] >= end and lay["total"][0] % 64 == 0


# (rays, bf16, n_iter, chunk rays, split rows): one ray; one tile; ragged
# tiles and chunks; a chunk boundary inside a tile's worth of rays; the
# training shapes at batch 4 and 32
CASES = [(1, True, 2, 4096, 4096), (8, True, 2, 4096, 4096),
         (100, False, 2, 16, 24), (1000, True, 3, 200, 1000),
         (1001, True, 1, 64, 100), (80000, True, 2, rd.K3_CHUNK_RAYS,
                                    rd.K3_SPLIT_ROWS),
         (640000, False, 2, rd.K3_CHUNK_RAYS, rd.K3_SPLIT_ROWS)]


@pytest.mark.parametrize("n,bf16,n_iter,chunk,split", CASES)
def test_chunks_and_tiles_cover_the_rays(n, bf16, n_iter, chunk, split):
    plan = rd.bwd_plan(n, KP, CRP, n_iter, bf16, 132, chunk, split)
    m = 64 if bf16 else 32
    assert plan["rows_per_tile"] == m
    c = plan["chunk_rays"]
    # whole tiles per chunk; chunks of at most the limit cover the rays,
    # none empty
    assert c % (m // 8) == 0 and c <= max(chunk, m // 8)
    assert (plan["n_chunks"] - 1) * c < n <= plan["n_chunks"] * c
    assert plan["tiles_per_chunk"] == -(-c // (m // 8))
    # the 64-row (wgmma) Pass A: two tiles a block, a block an SM
    assert plan["tile_slots"] == (2 if bf16 else 1)
    assert 1 <= plan["blocks_a"] <= min(132 * plan["tile_slots"],
                                        plan["tiles_per_chunk"])
    assert plan["n_inst"] == n_iter + 1


@pytest.mark.parametrize("n,bf16,n_iter,chunk,split", CASES)
def test_streams_are_disjoint_and_sized(n, bf16, n_iter, chunk, split):
    plan = rd.bwd_plan(n, KP, CRP, n_iter, bf16, 132, chunk, split)
    c = plan["chunk_rays"]
    widths = {"x": KP, "rf": CRP, "dt2": 128, "h2": 128, "dt3": 64}
    end = 0
    for name in rd.K3_STREAMS:
        off, rows, width, inst = plan["streams"][name]
        per_ray = name in ("rf", "dre_off", "dre_prob")
        assert rows == (c if per_ray else 8 * c), name
        assert width == widths.get(name, 256), name
        assert inst == (n_iter + 1 if name in ("h1", "dt2", "h2", "dt3")
                        else 1), name
        # 16-byte vectors and tensor-core fragments need aligned rows
        assert off % 64 == 0 and off >= end and width % 16 == 0, name
        end = off + rows * width * inst
    assert plan["scratch_elems"] >= end


def test_scratch_is_bounded_at_the_configured_batch():
    """The streams are sized by the chunk, not the batch: the configured
    batch 32 (640,000 rays of 8 pairs) needs no more scratch than one chunk
    of K3_CHUNK_RAYS rays, about 1.4 GB in bf16."""
    b4 = rd.bwd_plan(80000, KP, CRP, 2, True, 132)
    b32 = rd.bwd_plan(640000, KP, CRP, 2, True, 132)
    one = rd.bwd_plan(rd.K3_CHUNK_RAYS, KP, CRP, 2, True, 132)
    assert b32["n_chunks"] == 20 and b4["n_chunks"] == 3
    assert rd.bwd_scratch_bytes(b32, 2) <= rd.bwd_scratch_bytes(one, 2) \
        < 1.5e9
    # per pair row: X, both layer-1 cotangents, three tail instances of
    # h1, T(d_t2), h2, T(d_t3): ~5 KB, as the kernel's note says
    per_row = sum(r * w * i for _, r, w, i in one["streams"].values()) * 2 \
        / (8 * rd.K3_CHUNK_RAYS)
    assert 4800 < per_row < 5400


def _emulate(plan, streams, rows_c, rays_c, partials):
    """Pass B of one chunk, as the kernel runs it from the plan: each job's
    split s adds A[rows]^T B[rows] of its instance into its own padded
    partial."""
    tk, tn = rd.K3_TILE
    for job in plan["jobs"]:
        a, b = streams[job["a"]], streams[job["b"]]
        per_ray = job["a"] == "rf"
        rows = rays_c if per_ray else rows_c
        spi = job["splits_per_inst"]
        ld = job["tiles_n"] * tn
        stride = job["tiles_k"] * tk * ld
        for s in range(job["n_inst"] * spi):
            inst = job["inst0"] + s // spi
            r0 = (s % spi) * plan["split_rows"]
            r1 = min(r0 + plan["split_rows"], rows)
            if r0 >= r1:
                continue
            prod = a[inst, r0:r1].T @ b[inst, r0:r1]
            p = partials[job["p_off"] + s * stride:
                         job["p_off"] + (s + 1) * stride].reshape(-1, ld)
            p[:prod.shape[0], :prod.shape[1]] += prod


def _reduce(plan, partials, out):
    for r in plan["reds"]:
        for i in range(r["k"]):
            src = r["src"] + i * r["ld_src"] + np.arange(r["n"])
            acc = np.zeros(r["n"])
            for t in range(r["splits"]):  # in order, as the kernel sums
                acc += partials[src + t * r["stride"]]
            dst = r["dst"] + i * r["ld_dst"]
            out[dst:dst + r["n"]] += acc


@pytest.mark.parametrize("n,n_iter,chunk,split", [
    (1, 2, 64, 64), (37, 2, 16, 24), (100, 3, 40, 56), (130, 1, 64, 1000)])
def test_pass_b_and_reductions_reproduce_the_gradients(n, n_iter, chunk,
                                                       split):
    """Random operand streams for every chunk: the emulated split-K products
    and reductions equal each gradient's product over all rows (and all
    IEF instances for the offset decoder), and the small gradients' per-block
    partials sum to their totals. Integer-valued operands keep every sum
    exact, so any row counted twice or missed shows."""
    rng = np.random.default_rng(0)
    kp, crp = 48, 32
    plan = rd.bwd_plan(n, kp, crp, n_iter, True, 5, chunk, split)
    lay = rd.bwd_grad_layout(kp, crp)
    partials = np.zeros(plan["partial_floats"])
    want = {k: np.zeros(shape) for k, (_, shape) in lay.items()
            if k != "total"}
    c = plan["chunk_rays"]
    for ci in range(plan["n_chunks"]):
        rays_c = min(c, n - ci * c)
        rows_c = rays_c * 8
        streams = {}
        for name, (_, rows, width, inst) in plan["streams"].items():
            s = np.zeros((inst, rows, width))
            live = rays_c if rows == c else rows_c
            s[:, :live] = rng.integers(-3, 4, (inst, live, width))
            streams[name] = s
        _emulate(plan, streams, rows_c, rays_c, partials)
        for grad, col, a, b, ief in rd.K3_JOBS:
            insts = range(1, n_iter + 1) if ief else range(1)
            for i in insts:
                prod = streams[a][i].T @ streams[b][i]
                want[grad][:, col:col + prod.shape[1]] += prod
        # Pass A's small sums: each block adds its own row of partials
        for k in rd.K3_SMALL:
            size = math.prod(lay[k][1])
            for blk in range(plan["blocks_a"]):
                v = rng.integers(-3, 4, size)
                at = plan["small_off"] + blk * plan["small_size"] + \
                    plan["small"][k]
                partials[at:at + size] += v
                want[k] += v.reshape(lay[k][1])
    out = np.zeros(lay["total"][0])
    _reduce(plan, partials, out)
    for k, (off, shape) in lay.items():
        if k != "total":
            np.testing.assert_array_equal(
                out[off:off + math.prod(shape)].reshape(shape), want[k], k)


@pytest.mark.parametrize("n,bf16", [(100, True), (80000, True),
                                    (80000, False)])
def test_reductions_cover_each_gradient_once(n, bf16):
    plan = rd.bwd_plan(n, KP, CRP, 2, bf16, 132)
    lay = rd.bwd_grad_layout(KP, CRP)
    hits = np.zeros(lay["total"][0], np.int64)
    for r in plan["reds"]:
        for i in range(r["k"]):
            hits[r["dst"] + i * r["ld_dst"] + np.arange(r["n"])] += 1
    for k, (off, shape) in lay.items():
        if k != "total":
            assert (hits[off:off + math.prod(shape)] == 1).all(), k
    assert hits.sum() == sum(math.prod(s) for k, (_, s) in lay.items()
                             if k != "total")
    # the partial regions of the jobs, then the small sums, do not overlap
    spans = sorted((r["src"], r["src"] + r["splits"] * r["stride"])
                   for r in plan["reds"][:len(plan["jobs"])])
    spans.append((plan["small_off"], plan["partial_floats"]))
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    # Pass B's grid: every job's blocks, in order
    start = 0
    for j in plan["jobs"]:
        assert j["block0"] == start
        start += j["tiles_k"] * j["tiles_n"] * j["n_inst"] * \
            j["splits_per_inst"]
    assert plan["blocks_b"] == start


def test_packed_plan_layout():
    """The int64 array the C function reads: a 40-field header, 12 fields a
    job, 9 a reduction."""
    plan = rd.bwd_plan(1000, KP, CRP, 2, True, 132, 200, 1000)
    packed = rd.pack_bwd_plan(plan)
    assert len(packed) == 40 + 12 * len(plan["jobs"]) + 9 * len(plan["reds"])
    assert packed[:8] == [plan["chunk_rays"], plan["n_chunks"],
                          plan["blocks_a"], 64, 3, 1000, 8, 19]
    assert packed[8:18] == [plan["streams"][k][0] for k in rd.K3_STREAMS]
    assert packed[29:37] == [plan["small_size"], plan["small_off"],
                             plan["scratch_elems"], plan["partial_floats"],
                             plan["blocks_b"], plan["table_off"],
                             plan["table_stride"], plan["table_elems"]]
    j0 = packed[40:52]
    assert j0[:2] == [rd.K3_STREAMS.index("x"), rd.K3_STREAMS.index("de_off")]


def test_bwd_plan_refuses_empty_sizes():
    with pytest.raises(ValueError):
        rd.bwd_plan(0, KP, CRP, 2, True, 132)


def test_ray_decode_bwd_needs_the_card():
    """K3's wrapper launches the kernel or raises: a CPU tensor gets no
    silent fallback (training on the CPU goes through plain autograd)."""
    w = {k: torch.zeros(1) for k in rd.FORMAT.operands}
    w["pair_w1"] = torch.zeros((KP, 512))
    w["dims"] = (128, 155, 8)
    with pytest.raises(ValueError, match="CUDA"):
        rd.ray_decode_bwd(torch.zeros((4, 128)),
                          torch.zeros((2, 8), dtype=torch.int32),
                          torch.zeros((2, 8, 6)), torch.zeros((2, 155)), w,
                          None, torch.zeros((2, 8)), torch.zeros((2, 8)))


@pytest.mark.parametrize("n,bf16,blocks", [(100, True, 5), (80000, True, 132),
                                           (80000, False, 132)])
def test_table_copies_follow_the_other_partials(n, bf16, blocks):
    """Each Pass A block's copy of d_vox_table: ``table_stride`` floats (at
    least the table, 64-float aligned) from ``table_off``, past every job's
    partials and the small sums, inside ``partial_floats`` (which the C
    function zeroes before Pass A)."""
    plan = rd.bwd_plan(n, KP, CRP, 2, bf16, blocks, table_elems=TABLE)
    assert plan["table_elems"] == TABLE
    assert plan["table_stride"] >= TABLE and plan["table_stride"] % 64 == 0
    assert plan["table_off"] % 64 == 0
    assert plan["table_off"] >= plan["small_off"] + \
        plan["blocks_a"] * plan["small_size"]
    assert plan["partial_floats"] == plan["table_off"] + \
        plan["blocks_a"] * plan["table_stride"]


def test_table_copies_cost_a_bounded_scratch():
    """At the training shapes the copies add blocks x 1.49 MB: ~394 MB for
    the 264 tile slots (two a block, a block an SM) on 132 SMs, beside
    ~1.16 GB of streams and partials."""
    plan = rd.bwd_plan(80000, KP, CRP, 2, True, 132, table_elems=TABLE)
    base = rd.bwd_plan(80000, KP, CRP, 2, True, 132)
    extra = rd.bwd_scratch_bytes(plan, 2) - rd.bwd_scratch_bytes(base, 2)
    assert plan["blocks_a"] == 264
    assert 264 * TABLE * 4 <= extra < 264 * (TABLE + 64) * 4 + 256
    assert extra < 0.4e9


@pytest.mark.parametrize("blocks", [1, 3, 7])
def test_table_reduction_sums_the_copies_in_block_order(blocks):
    """The table's reduction, as the C function builds it from the plan
    (one Red over ``blocks_a`` copies ``table_stride`` apart), emulated with
    the emulation of the weight gradients' reductions: it adds every block's
    copy of every element once, in block order."""
    rng = np.random.default_rng(1)
    elems = 37 * 16
    plan = rd.bwd_plan(200, 48, 32, 2, True, blocks, 16, 24,
                       table_elems=elems)
    partials = np.zeros(plan["partial_floats"])
    copies = rng.integers(-3, 4, (plan["blocks_a"], elems)).astype(float)
    for b in range(plan["blocks_a"]):
        at = plan["table_off"] + b * plan["table_stride"]
        partials[at:at + elems] = copies[b]
    red = {"src": plan["table_off"], "stride": plan["table_stride"],
           "dst": 0, "splits": plan["blocks_a"], "k": 1, "n": elems,
           "ld_src": elems, "ld_dst": elems}
    out = np.zeros(elems)
    _reduce({"reds": [red]}, partials, out)
    np.testing.assert_array_equal(out, copies.sum(0))


@pytest.mark.parametrize("variant", ["stream writes", "products", "serial",
                                     "table sums", "staging X", "saved loads",
                                     "all six"])
def test_k3_attribution_edits_apply_to_the_sources(variant, tmp_path):
    """scripts/attribute_k3_passes.py's measurement builds of today's K3:
    every anchor it edits is found once in csrc/ray_decode_bwd.cu."""
    spec = importlib.util.spec_from_file_location(
        "attribute_k3_passes", ROOT / "scripts" / "attribute_k3_passes.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    d = mod.variant_dir(tmp_path, mod.VARIANTS[variant])
    text = (d / "ray_decode_bwd.cu").read_text()
    assert text.startswith(f"#define IDT_SKIP {mod.VARIANTS[variant]}")


# (kp, crp, c_vox, imnet_gf, bf16, rows): the default widths, the
# reference's options W4 (rgb_out 64: crp 544) and W7 (imnet_gf 128,
# pnet_out 512, multires 10, rgb_out 128: kp 640, crp 1056), and f32
PATH_CASES = {"default": (KP, CRP, 128, 64, True, 64),
              "W4": (KP, 544, 128, 64, True, 64),
              "W7": (640, 1056, 512, 128, True, 16),
              "f32": (KP, CRP, 128, 64, False, 32),
              "W7 f32": (640, 1056, 512, 128, False, 16)}


@pytest.mark.parametrize("case", list(PATH_CASES))
def test_pass_a_takes_wgmma_exactly_at_64_bf16_rows(case):
    """Pass A's instance follows the plan's rows: the wgmma one (two tiles
    a block) for every bf16 64-row plan, today's 32- and 16-row ones (one
    tile a block) otherwise; the packed plan carries those rows to the C
    function, which dispatches on them."""
    kp, crp, c_vox, g, bf16, rows = PATH_CASES[case]
    plan = rd.bwd_plan(1000, kp, crp, 2, bf16, 132, g=g, c_vox=c_vox)
    m = rd.bwd_rows(kp, crp, c_vox, 2, plan["small_size"], g, bf16)
    assert plan["rows_per_tile"] == m == rows
    wgmma = bf16 and m == 64
    assert plan["pass_a"] == ("wgmma" if wgmma else "wmma")
    assert plan["smem_a"] == rd.bwd_smem(m, g, crp, 2, plan["small_size"],
                                         bf16) <= common.MAX_SMEM
    assert plan["tile_slots"] == (2 if wgmma else 1)
    assert plan["blocks_a"] == min(132 * plan["tile_slots"],
                                   plan["tiles_per_chunk"])
    assert rd.pack_bwd_plan(plan)[3] == m


def _cpu_decode_operands(rng, n=5, kb=8, cv=16, c_roi=16, c_dir=27,
                         multires=2, gf=8, n_table=7):
    """Small f32 operands of the stage-1 decode on the CPU."""
    c_embed = cv + c_roi + 6 * (1 + 2 * multires) + c_dir
    w = {"off_enc_w": rng.normal(size=(1, 16)),
         "off_enc_b": 0.1 * rng.normal(size=(16,))}
    for prefix, in_dim in (("off_", c_embed + 16), ("prob_", c_embed)):
        dims = [(in_dim, 4 * gf), (4 * gf, 2 * gf), (2 * gf, gf), (gf, 1)]
        for i, (a, b) in enumerate(dims, 1):
            w[f"{prefix}w{i}"] = rng.normal(size=(a, b)) / np.sqrt(a)
            w[f"{prefix}b{i}"] = 0.1 * rng.normal(size=(b,))
    w32 = rd.split_ray_decode_weights(
        {k: torch.tensor(v, dtype=torch.float32) for k, v in w.items()},
        cv, c_roi, c_dir, multires, torch.float32)
    f = lambda a, dt=torch.float32: torch.tensor(a, dtype=dt)  # noqa: E731
    args = (f(rng.normal(size=(n_table, cv))).requires_grad_(),
            f(rng.integers(0, n_table, (n, kb)), torch.int32),
            f(0.6 * rng.normal(size=(n, kb, 6))),
            f(rng.normal(size=(n, c_roi + c_dir))).requires_grad_())
    return w32, args


@pytest.mark.parametrize("decode_bwd", rd.DECODE_BWD_MODES)
def test_wgmma_counter_starts_at_zero_and_the_cpu_route_leaves_it(
        decode_bwd):
    """``ray_decode_bwd.wgmma_launches`` starts at 0 and counts only K3
    launches on the card: the CPU route (plain autograd, every mode) leaves
    it and ``ray_decode_bwd.launches`` as they were."""
    assert rd.ray_decode_bwd.wgmma_launches == 0
    before = rd.ray_decode_bwd.launches
    w32, args = _cpu_decode_operands(np.random.default_rng(3))
    off, logit = rd.ray_decode_train(*args, w32, torch.bfloat16,
                                     decode_bwd=decode_bwd)
    (off.sum() + logit.sum()).backward()
    assert torch.isfinite(args[0].grad).all()
    assert rd.ray_decode_bwd.wgmma_launches == 0
    assert rd.ray_decode_bwd.launches == before
