"""The host-side arithmetic of the forward decodes K1/K2, K4 and K6
(``ops/decode_common.py::decode_plan``), on the CPU: each instance's shared
memory, its tiles and persistent grid, the slab ring and warp grid of the
bf16 products, and the schedule by which the weights stream through the
ring.

The CUDA kernels run only on the card (``test_torch_port_cuda.py``, which
also holds this plan against the sizes the kernels report). Here a numpy
emulation of the ring, driven by nothing but the plan, must reassemble each
weight operand from its slabs and reproduce each product. The JAX package
has no counterpart of this arithmetic: its kernels take whole weight
matrices into VMEM.
"""

import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest

from implicit_depth_torch.models.embedder import posenc_dim
from implicit_depth_torch.ops import cuda
from implicit_depth_torch.ops import decode_common as common
from implicit_depth_torch.ops import pair_decode as pd

ROOT = Path(__file__).resolve().parents[1]
# layer-1 widths of the default models (kp, crp): K1/K2 per pair and per
# ray; K4 and K6 per row
DEFAULT = {"K1": (240, 160), "K2all": (240, 160), "K4": (336, 0),
           "K6": (400, 0)}
WIDEST = {"K1": (common.MAX_KP["K1"], common.MAX_CRP),
          "K2all": (common.MAX_KP["K2all"], common.MAX_CRP),
          "K4": (common.MAX_KP["K4"], 0),
          "K6": (common.MAX_KP["K6"], 0)}
INSTANCES = [(k, bf16, widths) for k in ("K1", "K4", "K2all", "K6")
             for bf16 in (True, False) for widths in ("default", "widest")]
# the products ahead of the IEF tails in a tile's schedule
HEAD = {"K1": 6, "K2all": 6, "K4": 1, "K6": 4}


def _widths(kernel, which):
    return (DEFAULT if which == "default" else WIDEST)[kernel]


@pytest.mark.parametrize("kernel,bf16,which", INSTANCES)
def test_every_instance_fits_one_block(kernel, bf16, which):
    """K1 (and K2, the same layout), K4, K6, bf16 and f32: the regions, each at
    a 128-byte boundary and none overlapping, fit the 232,448 bytes of
    shared memory a block may use, at the default widths and at the widest
    the wrappers accept (there in the single layout: x1 is x0, and K1's
    per-ray part lies in the h2 region)."""
    kp, crp = _widths(kernel, which)
    plan = common.decode_plan(kernel, kp, crp, is_bf16=bf16)
    smem = plan["smem"]
    assert 0 < smem["total"] <= common.MAX_SMEM == 232448
    assert plan["single"] == (bf16 and which == "widest")
    if plan["single"]:
        assert smem["x1"] == smem["x0"]
        assert smem["ray"] == (smem["h2"] if crp else smem["h"])
    offs = sorted(smem.values())
    assert all(o % 128 == 0 for o in offs)
    assert offs[-1] == smem["total"] \
        and len(set(offs)) >= len(offs) - 2 - plan["single"]
    common.check_plan("test", kernel, kp, crp, 2, bf16, 1000)  # accepted


@pytest.mark.parametrize("kernel", ["K1", "K4", "K2all", "K6"])
def test_wrappers_refuse_what_does_not_fit(kernel):
    kp, crp = WIDEST[kernel]
    n_max = (common.MAX_SEGS - HEAD[kernel]) // 2
    for bad in ((kp + 16, crp, 2), (kp, crp + 16 if crp else 0, 2),
                (kp, crp, n_max + 1)):
        if bad == (kp, crp, 2):
            continue
        with pytest.raises(ValueError):
            common.check_plan("test", kernel, *bad, True, 1000)
    # the most IEF iterations a schedule holds
    assert len(common.decode_plan(kernel, kp, crp, n_max)["schedule"]) \
        <= common.MAX_SEGS


def test_default_bf16_layout():
    """The regions of K1's bf16 block at the default widths, byte by byte:
    two 64 x 248 layer-1 tiles, 16 x 168 per-ray rows, 16 x 256 f32 per-ray
    parts (one decoder's at a time), the 64 x 264 and 64 x 136 activations,
    three 18,432-byte slabs."""
    smem = common.decode_plan("K1", 240, 160)["smem"]
    assert smem == {"x0": 0, "x1": 31744, "rf": 63488, "ray": 68864,
                    "h": 85248, "h2": 119040, "ring": 136448,
                    "off": 191744, "logit": 192000, "l4": 192256,
                    "segs": 193280, "total": 193920}


@pytest.mark.parametrize("n", [0, 1, 8, 100, 1056, 76800, 80000, 614400])
@pytest.mark.parametrize("kernel", ["K1", "K4", "K6"])
def test_tiles_and_persistent_grid(kernel, n):
    """bf16: tiles of 64 rows (8 rays of K1) on at most one block per SM;
    f32: one block per tile of 32 rows (4 rays)."""
    per = 8 if kernel == "K1" else 64
    plan = common.decode_plan(kernel, *DEFAULT[kernel], n=n, sm_count=132)
    assert plan["rows_per_tile"] == 64
    assert plan["tiles"] == math.ceil(n / per)
    assert plan["blocks"] == min(plan["tiles"], 132)
    assert (plan["tiles"] - 1) * per < n <= plan["tiles"] * per or n == 0
    f32 = common.decode_plan(kernel, *DEFAULT[kernel], is_bf16=False, n=n)
    assert f32["tiles"] == f32["blocks"] == math.ceil(n / (per // 2))


@pytest.mark.parametrize("kernel", ["K1", "K4", "K6"])
@pytest.mark.parametrize("n_iter", [1, 2, 3])
def test_slab_ring_and_warp_grid_divide_the_products(kernel, n_iter):
    """Each product of the schedule: k a multiple of the 16-deep mma step;
    n a multiple of the warp grid's 4 x 16 (64-row products) or 8 x 16
    columns (K1's per-ray products), and n / 8 a power of two that a block's
    threads divide (the slab copy's mapping); a slab a multiple of 16 rows
    that fits its share of the ring."""
    plan = common.decode_plan(kernel, *DEFAULT[kernel], n_iter=n_iter)
    sched = plan["schedule"]
    assert len(sched) == HEAD[kernel] + 2 * n_iter
    for op, col, k, n, ks in sched:
        warps_n = common.WARPS if op == "ray_w1" else common.WARPS_N
        assert k % 16 == 0 and n % (warps_n * 16) == 0, op
        chunks = n // 8
        assert chunks & (chunks - 1) == 0 and 256 % chunks == 0, op
        assert ks == common.slab_rows(n) and ks % 16 == 0 and ks >= 16
        assert ks * (n + common.TILE_PAD) <= common.SLAB_ELEMS
    # 64 rows = 2 warps along M x 2 m16 tiles
    assert common.TILE_ROWS == (common.WARPS // common.WARPS_N) * 2 * 16
    assert plan["slabs_per_tile"] == sum(-(-k // ks) for *_, k, _, ks in sched)
    assert plan["slabs_per_tile"] >= common.RING  # the ring never laps a tile


@pytest.mark.parametrize("width", [16, 64, 128, 155, 160, 240, 256, 336, 384,
                                   400, 464, 512])
def test_shared_rows_are_aligned_and_conflict_free(width):
    """A row of width w (a multiple of 16 where the kernels use it as an
    mma operand) lies kPad elements apart: 16-byte aligned, and the eight
    16-byte rows of one ldmatrix fall in eight different bank groups."""
    w = -(-width // 16) * 16
    ld = w + common.TILE_PAD
    assert (ld * 2) % 16 == 0
    assert len({(r * ld * 2 // 16) % 8 for r in range(8)}) == 8


def _operands(rng, kernel, kp, crp):
    ops = {"pair_w1": rng.normal(size=(kp, 512)),
           "ray_w1": rng.normal(size=(crp, 512)),
           "w1": rng.normal(size=(kp, 512 if kernel == "K6" else 256))}
    for p in ("off_", "prob_", ""):
        ops[f"{p}w2"] = rng.normal(size=(256, 128))
        ops[f"{p}w3"] = rng.normal(size=(128, 64))
    return ops


@pytest.mark.parametrize("kernel", ["K1", "K4", "K6"])
def test_schedule_streams_each_weight_from_its_slabs(kernel):
    """Emulates the ring: each product's slabs, cut from its operand by the
    plan alone (k0, rows), reassemble the operand's column block, and the
    product summed slab by slab is the whole product. Layer 1 of K1 (and of
    K6) covers its 512 columns once, K1's per-ray part too, each decoder's
    half before that decoder's layer 1; the offset tail recurs once per IEF
    iteration."""
    rng = np.random.default_rng(0)
    kp, crp = DEFAULT[kernel]
    plan = common.decode_plan(kernel, kp, crp, n_iter=2)
    ops = _operands(rng, kernel, kp, crp)
    used = {}
    for op, col, k, n, ks in plan["schedule"]:
        w = ops[op]
        slabs = [w[k0:min(k0 + ks, k), col:col + n] for k0 in range(0, k, ks)]
        assert all(s.shape[0] % 16 == 0 for s in slabs)
        np.testing.assert_array_equal(np.concatenate(slabs, 0),
                                      w[:k, col:col + n])
        a = rng.normal(size=(64, k))
        acc = np.zeros((64, n))
        for i, s in enumerate(slabs):
            acc += a[:, i * ks:i * ks + s.shape[0]] @ s
        np.testing.assert_allclose(acc, a @ w[:k, col:col + n], rtol=1e-12,
                                   atol=1e-9)
        used.setdefault(op, []).append((col, n))
    if kernel == "K1":
        assert sorted(used["pair_w1"]) == [(0, 256), (256, 256)]
        assert used["ray_w1"] == [(256, 256), (0, 256)]
        assert len(used["off_w2"]) == 2 and len(used["prob_w2"]) == 1
    elif kernel == "K6":
        # the probability decoder's columns first (its tail runs before E1
        # is live), then the offset decoder's
        assert used["w1"] == [(256, 256), (0, 256)]
        assert len(used["off_w2"]) == 2 and len(used["prob_w3"]) == 1
    else:
        assert used["w1"] == [(0, 256)] and len(used["w2"]) == 2


# (layer-1 widths a kernel, imnet_gf) of the default model, of the
# reference's imnet_gf 128 (W2) and of every width option at its extreme
# at once (W7: pnet_out 512, multires 10, rgb_out 64, roi_out_bbox 4; K4's
# rows with the refine model's multires 8)
RING_WIDTHS = {"default": (DEFAULT, 64), "W2": (DEFAULT, 128),
               "W7": ({"K1": (640, 1056), "K4": (1616, 0), "K6": (1696, 0)},
                      128)}


@pytest.mark.parametrize("kernel", ["K1", "K4", "K6"])
@pytest.mark.parametrize("width", list(RING_WIDTHS))
def test_chunked_layer1_takes_each_row_and_slab_once(kernel, width):
    """Emulates a tile of the bf16 decodes from the plan alone: the ring
    hands out the schedule's slabs in order (each product's k-rows in
    slab_rows pieces), and each product takes them in its k order; a
    layer-1 product in the chunked layout stages X ``chunk`` columns at a
    time, each chunk a whole number of slabs but the last. Every k-row of X
    is staged once per decoder, in order, every slab is taken once, by its
    own product, at the k-rows of the chunk staged, and the chunks' products
    summed are X @ W. At W7 the layouts are chunked (K1 at imnet_gf 128:
    X in 304-column chunks beside the whole per-ray rows)."""
    widths, g = RING_WIDTHS[width]
    kp, crp = widths[kernel]
    plan = common.decode_plan(kernel, kp, crp, g=g)
    assert plan["smem"]["total"] <= common.MAX_SMEM
    assert (plan["layout"] == "chunked") == (width == "W7")
    if width == "W7":
        assert plan["chunk"] == {"K1": 304, "K4": 560, "K6": 560}[kernel]
        assert plan["smem"]["x0"] + TILE_BYTES * (plan["chunk"] + 8) \
            <= min(o for k, o in plan["smem"].items() if o > 0 and k != "x1")
    rng = np.random.default_rng(kp + g)
    g1 = 4 * g
    ops = {"pair_w1": rng.normal(size=(kp, 2 * g1)),
           "ray_w1": rng.normal(size=(crp, 2 * g1)),
           "w1": rng.normal(size=(kp, (2 if kernel == "K6" else 1) * g1))}
    for p in ("off_", "prob_", ""):
        ops[f"{p}w2"] = rng.normal(size=(g1, 2 * g))
        ops[f"{p}w3"] = rng.normal(size=(2 * g, g))
    x = rng.normal(size=(64, kp))
    ring = [(i, k0, min(k0 + ks, k))
            for i, (_, _, k, _, ks) in enumerate(plan["schedule"])
            for k0 in range(0, k, ks)]
    taken, layer1 = 0, 0
    for i, (op, col, k, n, ks) in enumerate(plan["schedule"]):
        w = ops[op][:, col:col + n]
        first = op in ("pair_w1", "w1")
        chunks = plan["chunks"] if first and plan["chunks"] else [(0, k)]
        a = x if first else rng.normal(size=(64, k))
        acc, staged = np.zeros((64, n)), []
        for k0, kn in chunks:
            xc = a[:, k0:k0 + kn].copy()  # the chunk buffer
            staged += range(k0, k0 + kn)
            for kk in range(0, kn, ks):  # product's slab loop
                seg, r0, r1 = ring[taken]
                taken += 1
                assert (seg, r0) == (i, k0 + kk), (op, k0, kk)
                assert r1 - r0 <= kn - kk
                acc += xc[:, kk:kk + r1 - r0] @ w[r0:r1]
        assert staged == list(range(k))
        np.testing.assert_allclose(acc, a @ w[:k], rtol=1e-12, atol=1e-9)
        layer1 += first
    assert taken == len(ring) == plan["slabs_per_tile"]
    assert layer1 == (1 if kernel == "K4" else 2)  # once per decoder


TILE_BYTES = common.TILE_ROWS * 2  # bytes of a column of X's 64 bf16 rows


def test_k6_default_bf16_layout():
    """K6's bf16 block at the default widths, byte by byte: two 64 x 408
    layer-1 tiles (kp 400 = vox 128 | ray row 160 | pe 102 | 0), no per-ray
    regions, the 64 x 264 and 64 x 136 activations, three 18,432-byte
    slabs: ~213 KB of the 227 KB."""
    smem = common.decode_plan("K6", 400)["smem"]
    assert smem == {"x0": 0, "x1": 52224, "rf": 104448, "ray": 104448,
                    "h": 104448, "h2": 138240, "ring": 155648,
                    "off": 210944, "logit": 211200, "l4": 211456,
                    "segs": 212480, "total": 213120}
    assert pd.pair_layout(128, 128, 27, 8) == {"c_rp": 160, "c_pe": 51,
                                               "o_pe": 288, "kp": 400}


# the layer-1 parts the model's options give K6: c_vox = pnet_out, c_roi =
# rgb_out x 2 x 2 (the ROI window), c_dir = posenc_dim(multires_views),
# pe = posenc_dim(multires) a position
@pytest.mark.parametrize("multires", [1, 2, 4, 6, 8, 10])
@pytest.mark.parametrize("c_vox", [8, 16, 32, 64, 128])
@pytest.mark.parametrize("rgb_out", [8, 16, 32])
def test_k6_fits_every_width_the_model_takes(multires, c_vox, rgb_out):
    """At 256-128-64-1, every pnet_out (a multiple of 8) up to the default
    128, rgb_out up to the default 32 and multires 1-10 with multires_views
    4: K6's layout fits one block in bf16 and f32, the positional encoding
    fits the lanes' columns, the wrapper's plan check accepts it, and every
    part of X starts at a 16-byte boundary (8 bf16) for cp.async."""
    lay = pd.pair_layout(c_vox, 4 * rgb_out, posenc_dim(4), multires)
    kp = lay["kp"]
    assert kp % 16 == 0 and lay["o_pe"] + 2 * lay["c_pe"] <= kp
    assert lay["c_rp"] % 8 == 0 and c_vox % 8 == 0
    assert kp - lay["o_pe"] <= pd.MAX_PE_COLS == 5 * 32
    for bf16 in (True, False):
        common.check_plan("test", "K6", kp, 0, 2, bf16, 614400)
        assert common.decode_plan("K6", kp, is_bf16=bf16)["smem"]["total"] \
            <= common.MAX_SMEM


def test_k6_widest_layout_is_the_smem_limit():
    """MAX_KP["K6"] is the row width of the reference's options at their
    extreme at once (pnet_out 512, rgb_out 64 with roi_out_bbox 4,
    multires 10): its block, X staged in chunks, fits at every imnet_gf,
    and 16 more columns are refused, naming the limit."""
    assert common.MAX_KP["K6"] == pd.pair_layout(512, 64 * 16, posenc_dim(4),
                                                 10)["kp"] == 1696
    for g in common.DECODER_GF:
        plan = common.decode_plan("K6", common.MAX_KP["K6"], g=g)
        assert plan["layout"] == "chunked"
        assert plan["smem"]["total"] <= common.MAX_SMEM
    with pytest.raises(ValueError, match="kp up to 1696"):
        common.check_plan("test", "K6", common.MAX_KP["K6"] + 16, 0, 2, True,
                          100)


def _attribution_script():
    spec = importlib.util.spec_from_file_location(
        "attribute_k1_k4", ROOT / "scripts" / "attribute_k1_k4.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("variant", ["products", "weight slabs", "epilogues",
                                     "input staging", "all"])
def test_attribution_edits_apply_to_the_sources(variant, tmp_path):
    """scripts/attribute_k1_k4.py's measurement builds of today's kernels:
    every anchor it edits is found once in csrc/."""
    mod = _attribution_script()
    assert mod.version(cuda.CSRC) == "staged"
    d = mod.variant_dir(cuda.CSRC, tmp_path, "staged",
                        mod.VARIANTS["staged"][variant])
    text = (d / "decode_tile.cuh").read_text()
    assert text.startswith("#ifndef IDT_SKIP") and "IDT_SKIP &" in text


@pytest.mark.parametrize("bf16", [True, False])
def test_save_all_has_k1s_layout_and_schedule(bf16):
    """K2 'all' stores its saves from registers and from the shared h2 tile
    straight to device memory: its block is K1's, region by region, with
    K1's tiles, grid and weight schedule."""
    for n in (0, 100, 80000):
        assert common.decode_plan("K2all", 240, 160, is_bf16=bf16, n=n) == \
            common.decode_plan("K1", 240, 160, is_bf16=bf16, n=n)
