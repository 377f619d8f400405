"""What the decode families share: the Python side of
``csrc/decode_common.cuh`` and ``csrc/decode_tile.cuh``.

The families are K1-K3 (``ops/ray_decode.py``), K4 (``ops/ief_decode.py``)
and K6 (``ops/pair_decode.py``). This module holds:

* the plain decoder math: :func:`act`, :func:`dot`, :func:`rounded`,
  :func:`squash`, the MLP tail (:func:`mlp_tail`), the IEF loop
  (:func:`ief_loop`) and the rank-1 fold of the offset encoder
  (:func:`rank1`). Rounding follows the JAX package's ``_decode_rows`` /
  ``_ief_rows``: every product takes compute-dtype operands with f32
  accumulation, and each hidden activation is rounded to the compute dtype
  before its product;
* the operand format: a family describes its operands once
  (:class:`OperandFormat`), and one split (:func:`split_operands`), one pad
  (:func:`pad_operands`), one cast (:func:`cast_operands`) and one bias
  rounding (:func:`round_biases`) serve all three. The kernels are compiled
  for the decoder widths 4g-2g-g-1 of ``imnet_gf`` g in
  :data:`DECODER_GF`, read from the weights (:func:`decoder_gf`). Any g from
  1 to 128 runs at the next compiled width (:func:`compiled_gf`) with zero
  units: a padded unit's pre-activation is 0, LeakyReLU(0) = 0 and its row
  in the next layer is 0, so the outputs are those of the narrower decoder.
  A voxel width (c_vox, c_end) is padded to a multiple of
  :data:`VOX_MULTIPLE` the same way, with zero rows of layer 1 and zero
  columns of the table or end rows (:func:`rows_operand`). The padding is
  slicing, concatenation and ``F.pad``, so under autograd the pads'
  gradients are dropped;
* the forward plan of K1, K2, K4 and K6 (:func:`decode_plan`): their tiles,
  shared memory and weight schedule as ``csrc/decode_tile.cuh`` lays them
  out, and :func:`check_plan`, which refuses the widths a kernel is not
  given at, naming the limit;
* the device checks :func:`check_cuda` and :func:`aligned`.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict

import torch
import torch.nn.functional as F

from implicit_depth_torch.ops import cuda

LEAKY = 0.02
# the kernels' K-dimension granule (bf16 tensor-core fragment depth)
K_GRANULE = 16


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def posenc_dim(multires: int, input_dims: int = 3, enabled: bool = True) -> int:
    """Columns of the positional encoding of ``input_dims`` coordinates: the
    input, then a sin and a cos block per frequency (``input_dims`` when
    disabled)."""
    if not enabled or multires <= 0:
        return input_dims
    return input_dims * (1 + 2 * multires)


# -- the plain decoder math ---------------------------------------------------

def act(v):
    return torch.where(v > 0, v, LEAKY * v)


def soft_clamp(x):
    return torch.maximum(torch.minimum(x, 0.01 * x + 0.99), 0.01 * x)


def squash(x, use_sigmoid: bool):
    return torch.sigmoid(x) if use_sigmoid else soft_clamp(x)


def rounded(x, dtype):
    """``x`` rounded to ``dtype``, held in f32. Under autograd the rounding
    is a straight-through step: the gradient reaches ``x`` unrounded, so
    that weight gradients stay f32 as the JAX kernel accumulates them.
    float64 (the yardstick of the f32 sums): ``x`` in float64."""
    if dtype == torch.float64:
        return x.double()
    r = x.to(dtype).float()
    if x.dtype == torch.float32 and torch.is_grad_enabled() and x.requires_grad:
        return x + (r - x).detach()
    return r


def dot(a, b, dtype):
    """a @ b with ``dtype`` operands and f32 accumulation."""
    return rounded(a, dtype) @ rounded(b, dtype)


def rank1(enc_w, enc_b, w_x, dtype):
    """a_vec, c_vec (4g,) f32 of the offset encoder folded into layer 1:
    (offset·enc_w + enc_b) @ W_x = offset·a_vec + c_vec."""
    return dot(enc_w, w_x, dtype)[0], dot(enc_b[None, :], w_x, dtype)[0]


def mlp_tail(h1, w, prefix, dtype):
    """Layers 2-4 from the rounded layer-1 activation; returns (rows,) f32."""
    h2 = act(dot(h1, w[f"{prefix}w2"], dtype) + w[f"{prefix}b2"])
    h3 = act(dot(h2, w[f"{prefix}w3"], dtype) + w[f"{prefix}b3"])
    return dot(h3, w[f"{prefix}w4"][:, None], dtype)[:, 0]


def ief_loop(e1, w, prefix, n_iter, init_offset, dtype):
    """The IEF iterations over the hoisted layer-1 pre-activation ``e1``;
    returns the final offset (rows,) f32."""
    offset = torch.full(e1.shape[:1], init_offset, dtype=torch.float32,
                        device=e1.device)
    for _ in range(n_iter):
        h1 = act(e1 + offset[:, None] * w["a_vec"] + w["c_vec"])
        offset = offset + mlp_tail(h1, w, prefix, dtype) + w[f"{prefix}b4"]
    return offset


# -- the operand format -------------------------------------------------------

# imnet_gf of the decoders the kernels are compiled for: layers 4g -> 2g ->
# g -> 1; every g up to the last is run at the next of them
DECODER_GF = cuda.DECODER_GF
MAX_GF = DECODER_GF[-1]
# the voxel width (c_vox, c_end) the operands are padded to a multiple of:
# K1, K2, K4 and K6 take a multiple of 8 in bf16 (16-byte rows), K3's
# d_rows product runs on the tensor cores at a multiple of 16 (another
# multiple of 8 takes CUDA-core FMA); one multiple, so one padded table
VOX_MULTIPLE = 16


def compiled_gf(g: int) -> int:
    """The compiled width a decoder of imnet_gf ``g`` runs at: the least of
    :data:`DECODER_GF` not below it (its other units zero)."""
    for c in DECODER_GF:
        if g <= c:
            return c
    raise ValueError(f"the decode kernels take imnet_gf 1 to {MAX_GF} "
                     f"(got {g})")


def decoder_gf(name: str, g1: int, w2_shape, w3_shape) -> int:
    """The ``imnet_gf`` g of a decoder whose layer 1 is ``g1`` wide and
    whose layers 2 and 3 have the shapes ``w2_shape``, ``w3_shape``; raises
    unless the widths are 4g-2g-g-1 for a g from 1 to :data:`MAX_GF`."""
    g = g1 // 4
    widths = (g1, *w3_shape)
    if not 1 <= g <= MAX_GF or g1 != 4 * g \
            or tuple(w2_shape) != (g1, 2 * g) \
            or tuple(w3_shape) != (2 * g, g):
        raise ValueError(
            f"{name} kernel takes decoder widths 4g-2g-g-1 for imnet_gf g "
            f"from 1 to {MAX_GF} (got {'-'.join(map(str, widths))}-1)")
    return g


@dataclasses.dataclass(frozen=True)
class OperandFormat:
    """A decode family's weight operands.

    ``operands``: their names in the kernel's order. ``layer1``: the
    layer-1 matrices, each with the decoders' columns side by side in the
    order of ``prefixes``; the first holds the voxel (end) row's weights in
    its first ``dims[0]`` rows. ``prefixes``: the decoders, whose layers 2-4
    are ``{prefix}w2`` .. ``{prefix}b4`` and whose first, the IEF offset
    decoder, has the offset encoder. ``rounded``: the biases the kernel
    adds rounded to the compute dtype. ``layout``: the family's layer-1
    layout at its ``dims`` (the operands' ``"dims"``), whose ``"kp"`` is the
    first layer-1 matrix's rows."""
    operands: tuple
    layer1: tuple
    prefixes: tuple
    rounded: tuple
    layout: Callable[..., dict]

    @property
    def matrices(self) -> tuple:
        return self.layer1 + tuple(f"{p}{n}" for p in self.prefixes
                                   for n in ("w2", "w3", "w4"))


def operands_gf(name: str, w: Dict[str, torch.Tensor],
                fmt: OperandFormat) -> int:
    """The ``imnet_gf`` g of the operands ``w`` of the format ``fmt``;
    raises unless each of its decoders is 4g-2g-g-1 (:func:`decoder_gf`)."""
    g1 = w["b1"].shape[0] // len(fmt.prefixes)
    for p in fmt.prefixes:
        g = decoder_gf(name, g1, w[f"{p}w2"].shape, w[f"{p}w3"].shape)
    return g


def split_operands(weights: Dict[str, torch.Tensor], fmt: OperandFormat,
                   c_embed: int, dims: tuple, layer1_rows,
                   dtype) -> Dict[str, torch.Tensor]:
    """The decoder weights (JAX layout: ``{prefix}w1..w4``,
    ``{prefix}b1..b4`` of each decoder, kernels (in, out), and the offset
    encoder's ``{prefix}enc_w``, ``{prefix}enc_b`` of the first) as the
    family's operands, all in f32: ``layer1_rows`` maps layer 1's rows
    over the embedding (``c_embed`` of them; the decoders' columns side by
    side) to the matrices ``fmt.layer1``; b1, the decoders' first biases
    side by side; a_vec, c_vec of the offset encoder folded into layer 1
    (the offset decoder's rows past ``c_embed``) with ``dtype`` operands;
    each decoder's layers 2-4; and ``dims``. Only slicing, concatenation
    and the rank-1 fold: training differentiates through it, which lays the
    kernels' split gradients back onto the parameters."""
    p0 = fmt.prefixes[0]
    w1 = torch.cat([weights[f"{p}w1"][:c_embed] for p in fmt.prefixes], 1)
    a_vec, c_vec = rank1(weights[f"{p0}enc_w"], weights[f"{p0}enc_b"],
                         weights[f"{p0}w1"][c_embed:], dtype)
    w = {k: m.float() for k, m in zip(fmt.layer1, layer1_rows(w1))}
    w.update(b1=torch.cat([weights[f"{p}b1"] for p in fmt.prefixes]).float(),
             a_vec=a_vec, c_vec=c_vec)
    for p in fmt.prefixes:
        for n in ("w2", "b2", "w3", "b3"):
            w[f"{p}{n}"] = weights[f"{p}{n}"].float()
        w[f"{p}w4"] = weights[f"{p}w4"].reshape(-1).float()
        w[f"{p}b4"] = weights[f"{p}b4"].reshape(1).float()
    w["dims"] = dims
    return w


def pad_to(t, shape):
    """``t`` with zeros appended along each dimension up to ``shape`` (a
    dimension already as long is left as it is)."""
    pads = []
    for have, want in zip(reversed(t.shape), reversed(shape)):
        pads += [0, max(0, want - have)]
    return F.pad(t, pads) if any(pads) else t


def pad_columns(t, c):
    """The rows ``t`` (rows, c0) with zero columns appended up to ``c``.
    ``t`` itself where c0 >= c."""
    return pad_to(t, (t.shape[0], c))


def rows_operand(t, w, fmt: OperandFormat):
    """The voxel table or end rows ``t`` as the kernel takes them beside the
    operands ``w``: in their compute dtype, with zero columns up to the
    padded voxel width ``w["dims"][0]``."""
    return pad_columns(t.to(w[fmt.layer1[0]].dtype), w["dims"][0])


def _widen(t, g4, to):
    """The last dimension [decoder 0 (g4) | decoder 1 (g4) ...] of ``t``
    with each decoder's part padded with zeros to ``to``."""
    h = t.reshape(*t.shape[:-1], -1, g4)
    return pad_to(h, (*h.shape[:-1], to)).reshape(*t.shape[:-1], -1)


def _insert_rows(w1, at, n_zero, rows):
    """``w1`` with ``n_zero`` zero rows inserted before row ``at`` (the
    columns a voxel width is padded by), its trailing zero rows then cut or
    padded to ``rows``."""
    if n_zero == 0 and w1.shape[0] == rows:
        return w1
    w = torch.cat([w1[:at], w1.new_zeros((n_zero, *w1.shape[1:])),
                   w1[at:]], 0)[:rows]
    return pad_to(w, (rows, *w.shape[1:]))


def pad_operands(w: Dict[str, torch.Tensor],
                 fmt: OperandFormat) -> Dict[str, torch.Tensor]:
    """The operands ``w`` (the f32 split, or its cast) at the kernels'
    widths: the decoders padded to :func:`compiled_gf` with zero units, the
    voxel width ``dims[0]`` to a multiple of :data:`VOX_MULTIPLE` with zero
    rows of the first layer-1 matrix, whose rows then become the family's
    kp at the padded dims (the table or end rows take as many zero columns:
    :func:`rows_operand`). ``w`` itself where nothing is padded."""
    c = w["dims"][0]
    g = w["b1"].shape[0] // (4 * len(fmt.prefixes))
    G, cv = compiled_gf(g), round_up(c, VOX_MULTIPLE)
    if (g, c) == (G, cv):
        return w
    dims = (cv, *w["dims"][1:])
    out = dict(w, dims=dims)
    first, *rest = fmt.layer1
    out[first] = _widen(_insert_rows(w[first], c, cv - c,
                                     fmt.layout(*dims)["kp"]), 4 * g, 4 * G)
    for k in (*rest, "b1"):
        out[k] = _widen(w[k], 4 * g, 4 * G)
    out["a_vec"] = pad_to(w["a_vec"], (4 * G,))
    out["c_vec"] = pad_to(w["c_vec"], (4 * G,))
    for p in fmt.prefixes:
        out[f"{p}w2"] = pad_to(w[f"{p}w2"], (4 * G, 2 * G))
        out[f"{p}b2"] = pad_to(w[f"{p}b2"], (2 * G,))
        out[f"{p}w3"] = pad_to(w[f"{p}w3"], (2 * G, G))
        out[f"{p}b3"] = pad_to(w[f"{p}b3"], (G,))
        out[f"{p}w4"] = pad_to(w[f"{p}w4"], (G,))
    return {k: v.contiguous() if torch.is_tensor(v) else v
            for k, v in out.items()}


def round_biases(w: Dict[str, torch.Tensor], fmt: OperandFormat,
                 dtype) -> Dict[str, torch.Tensor]:
    """``w`` with the biases ``fmt.rounded`` rounded to ``dtype`` as the
    kernel adds them (held in f32; a straight-through step under
    autograd)."""
    return {**w, **{k: rounded(w[k], dtype) for k in fmt.rounded}}


def cast_operands(w: Dict[str, torch.Tensor], fmt: OperandFormat,
                  dtype) -> Dict[str, torch.Tensor]:
    """The f32 operands as the kernel takes them: the matrices in
    ``dtype``, the biases ``fmt.rounded`` rounded to it
    (:func:`round_biases`)."""
    out = round_biases(w, fmt, dtype)
    for k in fmt.matrices:
        out[k] = w[k].to(dtype).contiguous()
    return out


# -- the device checks --------------------------------------------------------

def check_cuda(name, tensors, dtype):
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: all operands must be CUDA tensors")
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: compute dtype {dtype} not supported")


def aligned(t):
    """``t`` at a 16-byte aligned address (the kernels load 16 bytes at a
    time): a fresh copy where a view starts elsewhere."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


# -- the forward decodes' plan (K1/K2, K4, K6): tiles, shared memory, schedule

MAX_SMEM = 232448      # dynamic shared memory one block may use (H100)
TILE_ROWS = 64         # rows of a bf16 tile (decode_tile.cuh kM)
TILE_PAD = 8           # elements past each shared row's width (kPad)
SLAB_ELEMS = 9216      # elements of one weight slab (kSlabElems)
RING = 3               # weight slabs in shared memory (kRing)
MAX_SEGS = 24          # products of one tile's schedule (kMaxSegs)
WARPS, WARPS_N = 8, 4  # warps of a block; along N in the 64-row products
# rows of an f32 block (FMA path): the first whose block fits (16 at
# imnet_gf 128, and for K4's and K6's widest rows at any imnet_gf)
F32_ROWS = (32, 16)
# the widest layer-1 inputs the wrappers accept, those of every width option
# of the reference at its extreme at once (pnet_out 512, multires 10,
# rgb_out 64, roi_out_bbox 4, refine pnet_out 512): per pair (kp; K1, K2,
# K3: 512 + 6 + 120 -> 640), per ray (crp; K1, K3: rgb_out *
# roi_out_bbox^2 + dir_e, 1024 + 27 -> 1056); K4's and K6's rows also hold
# the per-ray part (K4 1616 with the refine model's multires 8, K6 1696).
# Every block fits at these widths at every compiled imnet_gf (decode_plan's
# chunked layout and 16-row f32 blocks; ray_decode.py::bwd_rows' 16-row
# tiles).
MAX_KP = {"K1": 640, "K2all": 640, "K4": 1696, "K6": 1696, "K3": 640}
MAX_CRP = 1056
MAX_CVOX = 512  # K3's voxel feature width (pnet_out): its d_rows tile
_SEG_BYTES = 24        # sizeof(Seg)
# the most pair slots a ray K1, K2 and K3 take (decode_common.cuh kMaxKb): a
# ray of a grid of up to 22 cells a side crosses at most 3·22 - 2 cells
MAX_KB = 64
# whole rays of a tile at most: K1's bf16 tile (its per-ray product's 16
# rows) and f32 block (ray_decode.cu kTcRays, kF32Rays), K3's tile of
# rows_per_tile rows (its per-ray regions' rows_per_tile / 8)
TC_RAYS, F32_RAYS = 16, 4


def rays_per_tile(kb: int, rows: int, cap: int) -> int:
    """The whole rays of ``kb`` pair slots that a tile of ``rows`` rows
    holds, at most ``cap``; 1 where a ray's slots fill more than a tile
    (kb > rows: the ray then spans ceil(kb / rows) tiles of its slots).
    Mirrors decode_common.cuh::rays_per_tile."""
    return 1 if kb > rows else min(rows // kb, cap)


def tile_rows(kb: int, rows: int, rays: int, n: int, tile: int) -> list:
    """The pair row (ray·kb + slot) of each row of tile ``tile`` of ``n``
    rays, or None where the row is masked (past the tile's rays or past
    the ray's slots), as the kernels map them: the tile's rays are
    consecutive, ``rays`` of them, or (kb > rows) the tile is rows slots of
    one ray. The CPU plan tests hold this map to cover each pair row once."""
    spt, tpr = min(kb, rows), -(-kb // rows)
    ray0, slot0 = tile // tpr * rays, tile % tpr * spt
    out = []
    for r in range(rows):
        ray, slot = ray0 + r // spt, slot0 + r % spt
        ok = r // spt < rays and ray < n and slot < kb
        out.append(ray * kb + slot if ok else None)
    return out


def slab_rows(n: int) -> int:
    """k-rows of one weight slab of a product ``n`` wide (16-row multiple)."""
    return SLAB_ELEMS // (n + TILE_PAD) // 16 * 16


def _regions(sizes):
    """{name: byte offset} of consecutive regions, each 128-byte aligned,
    and the total under "total"."""
    out, o = {}, 0
    for name, size in sizes:
        out[name] = o
        o = round_up(o + size, 128)
    out["total"] = o
    return out


def _tile_layout(kp: int, crp: int, g: int, k1: bool, kind: str,
                 chunk: int = 0) -> dict:
    """``tile::Smem``'s regions in the ``kind`` layout ("double", "single",
    "chunked": X's buffer ``chunk`` columns wide)."""
    ld = lambda w: w + TILE_PAD  # noqa: E731
    xw = chunk if kind == "chunked" else kp
    xb = TILE_ROWS * ld(xw) * 2 if xw else 0
    one = kind != "double"
    out = _regions([
        ("x0", xb), ("x1", 0 if one else xb),
        ("rf", TC_RAYS * ld(crp) * 2 if k1 else 0),
        ("ray", TC_RAYS * 4 * g * 4 if k1 and not one else 0),
        ("h", TILE_ROWS * ld(4 * g) * 2), ("h2", TILE_ROWS * ld(2 * g) * 2),
        ("ring", RING * SLAB_ELEMS * 2), ("off", TILE_ROWS * 4),
        ("logit", TILE_ROWS * 4), ("l4", WARPS_N * TILE_ROWS * 4),
        ("segs", MAX_SEGS * _SEG_BYTES)])
    if one:
        out["x1"] = out["x0"]
        if k1:
            out["ray"] = out["h2"]
    return out


def tile_layout(kp: int, crp: int, g: int, k1: bool) -> tuple:
    """(kind, chunk, regions) of a bf16 decode block: the first of the
    double, single and chunked layouts that fits MAX_SMEM (the chunked one
    may not: its total says so). The chunk is the most columns of X that
    fit beside the other regions, a multiple of the layer-1 product's slab
    rows (at least one slab), so that every chunk but the last takes whole
    slabs (``csrc/decode_tile.cuh::Smem``)."""
    for kind in ("double", "single"):
        smem = _tile_layout(kp, crp, g, k1, kind)
        if smem["total"] <= MAX_SMEM:
            return kind, 0, smem
    rest = _tile_layout(0, crp, g, k1, "chunked")["total"]
    ks = slab_rows(4 * g)
    chunk = min(kp, max(ks, ((MAX_SMEM - rest) // (TILE_ROWS * 2)
                             - TILE_PAD) // ks * ks))
    return "chunked", chunk, _tile_layout(kp, crp, g, k1, "chunked", chunk)


def f32_layout(kernel: str, m: int, kp: int, crp: int, g: int) -> dict:
    """The f32 FMA kernels' ``Smem`` of ``m`` rows a block."""
    g1, g2, g3 = 4 * g, 2 * g, g
    x = m * max(kp, g2 + g3) * 4
    if kernel in ("K1", "K2all"):
        # c: product scratch, first the per-ray inputs
        return _regions([("x", x), ("e1", m * g1 * 4),
                         ("c", max(m * g1, F32_RAYS * crp) * 4),
                         ("h", m * g1 * 4), ("ray", F32_RAYS * 2 * g1 * 4),
                         ("off", m * 4), ("logit", m * 4)])
    if kernel == "K6":
        return _regions([("x", x), ("e1", m * g1 * 4), ("c", m * g1 * 4),
                         ("h", m * g1 * 4), ("off", m * 4), ("logit", m * 4)])
    return _regions([("x", x), ("e1", m * g1 * 4), ("c", m * g2 * 4),
                     ("h", m * g1 * 4), ("off", m * 4)])


def decode_plan(kernel: str, kp: int, crp: int = 0, n_iter: int = 2,
                is_bf16: bool = True, n: int = 0, sm_count: int = 132,
                g: int = 64, kb: int = 8) -> dict:
    """The host-side arithmetic of the forward decodes, as the kernels lay
    it out: ``kernel`` "K1" (also K2; ``n`` rays of ``kb`` pairs, layer-1
    widths ``kp`` per pair and ``crp`` per ray), "K2all" (K2 'all': K1's
    layout, its saves go from registers and the shared h2 tile to device
    memory), "K4" (``n`` rows, layer-1 width ``kp``) or "K6" (``n`` pair
    rows, layer-1 width ``kp``: ``ops/pair_decode.py::pair_layout``; the
    operand "w1" holds both decoders' layer 1, offset columns first); the
    decoders' widths 4g-2g-g-1 of imnet_gf ``g``.

    bf16 (``csrc/decode_tile.cuh``): a persistent grid of ``blocks`` = one
    block per SM (at most the number of tiles) walks ``tiles`` tiles of
    TILE_ROWS rows (K1: ``rays_per_tile`` whole rays, :func:`tile_rows`);
    ``smem`` holds the byte offset of each region of ``tile::Smem`` and
    ``"total"``, in the ``layout`` :func:`tile_layout` takes: "double"
    where it fits MAX_SMEM, else "single" (``single``: one X buffer, x1 =
    x0, and K1's per-ray part in the h2 region), else "chunked" (also
    ``single``; x0 holds ``chunk`` columns of X, which each decoder's layer
    1 takes in ``chunks``: (first column, columns) each; 0 and [] where X is
    whole); ``schedule`` lists each
    product of a tile in the order its weights stream through the slab
    ring: (operand, first column, k, n, slab rows), ``slabs_per_tile``
    their number, and ``warp_grid`` each product's warps and tiles
    (:func:`warp_grid`). f32: one block per tile of ``rows_per_tile`` rows,
    the first of F32_ROWS whose block fits (K1: ``rays_per_tile`` whole
    rays or, at kb > rows, ``tiles_per_ray`` tiles of one ray's slots), the
    FMA kernels' ``Smem`` (no schedule)."""
    if kernel not in ("K1", "K2all", "K4", "K6"):
        raise ValueError(f"decode_plan: kernel {kernel!r}")
    k1 = kernel in ("K1", "K2all")
    if k1 and not 1 <= kb <= MAX_KB:
        raise ValueError(f"decode_plan: kb in [1, {MAX_KB}] (got {kb})")
    g1, g2, g3 = 4 * g, 2 * g, g
    if is_bf16:
        layout, chunk, smem = tile_layout(kp, crp, g, k1)
        tail = [("w2", 0, g1, g2), ("w3", 0, g2, g3)]
        if k1:
            # each decoder's per-ray part just before its layer 1
            sched = [("ray_w1", g1, crp, g1), ("pair_w1", g1, kp, g1),
                     *((f"prob_{w}", c, k, nn) for w, c, k, nn in tail),
                     ("ray_w1", 0, crp, g1), ("pair_w1", 0, kp, g1),
                     *((f"off_{w}", c, k, nn) for _ in range(n_iter)
                       for w, c, k, nn in tail)]
        elif kernel == "K6":
            sched = [("w1", g1, kp, g1),
                     *((f"prob_{w}", c, k, nn) for w, c, k, nn in tail),
                     ("w1", 0, kp, g1),
                     *((f"off_{w}", c, k, nn) for _ in range(n_iter)
                       for w, c, k, nn in tail)]
        else:
            sched = [("w1", 0, kp, g1),
                     *(s for _ in range(n_iter) for s in tail)]
        sched = [(op, c, k, nn, slab_rows(nn)) for op, c, k, nn in sched]
        rows = TILE_ROWS
        rays = rays_per_tile(kb, rows, TC_RAYS) if k1 else 0
        tiles = -(-n // (rays if k1 else rows))
        return {"rows_per_tile": rows, "tiles": tiles,
                "rays_per_tile": rays, "tiles_per_ray": 1,
                "blocks": min(tiles, sm_count), "smem": smem,
                "layout": layout, "single": layout != "double",
                "chunk": chunk,
                "chunks": [(k0, min(chunk, kp - k0))
                           for k0 in range(0, kp, chunk)] if chunk else [],
                "schedule": sched,
                "slabs_per_tile": sum(-(-k // s) for _, _, k, _, s in sched),
                "warp_grid": [warp_grid(16 if op == "ray_w1" else rows, nn)
                              for op, _, _, nn, _ in sched]}
    for m in F32_ROWS:
        smem = f32_layout(kernel, m, kp, crp, g)
        if smem["total"] <= MAX_SMEM:
            break
    rays = rays_per_tile(kb, m, F32_RAYS) if k1 else 0
    tpr = -(-kb // m) if k1 else 1
    tiles = -(-n // rays) * tpr if k1 else -(-n // m)
    return {"rows_per_tile": m, "tiles": tiles, "rays_per_tile": rays,
            "tiles_per_ray": tpr, "blocks": tiles, "smem": smem,
            "layout": "f32", "single": False, "chunk": 0, "chunks": [],
            "schedule": [], "slabs_per_tile": 0}


def warp_grid(rows: int, n: int) -> dict:
    """The warp grid of a bf16 product ``rows`` (64: a tile; 16: K1's
    per-ray rows) by ``n`` columns (``csrc/decode_tile.cuh::Grid``): ``wn``
    warps along N (at most WARPS_N for a tile, all WARPS for the per-ray
    rows), ``wm`` along M, each ``mt`` m16 by ``nt`` n8 tiles; ``active``
    warps own a tile, the others only meet the barriers."""
    tm, tn = rows // 16, n // 8
    wn = min(tn, WARPS if rows == 16 else WARPS_N)
    wm = min(tm, WARPS // wn)
    return {"wn": wn, "wm": wm, "mt": tm // wm, "nt": tn // wn,
            "active": wm * wn}


@functools.lru_cache(maxsize=256)
def check_plan(name, kernel, kp, crp, n_iter, is_bf16, n, g=64, kb=8):
    """Raises unless the kernel takes these widths (at the compiled imnet_gf
    ``g``), naming the limit; returns the plan (not to be modified). Kept
    per shape, so that a sub-millisecond launch (K4, K6 ``global``) does
    not wait on the plan's host arithmetic every call."""
    if g not in DECODER_GF:
        raise ValueError(f"{name} kernel takes imnet_gf g in {DECODER_GF} "
                         f"(got {g}; the operands' padding runs any g up to "
                         f"{MAX_GF} at the next)")
    if kp > MAX_KP[kernel]:
        raise ValueError(f"{name} kernel takes layer-1 inputs kp up to "
                         f"{MAX_KP[kernel]} (got kp={kp})")
    if crp > MAX_CRP:
        raise ValueError(f"{name} kernel takes per-ray inputs crp up to "
                         f"{MAX_CRP} (got crp={crp})")
    plan = decode_plan(kernel, kp, crp, n_iter, is_bf16, n, g=g, kb=kb)
    if plan["smem"]["total"] > MAX_SMEM or len(plan["schedule"]) > MAX_SEGS:
        raise ValueError(f"{name}: widths kp={kp}, crp={crp}, imnet_gf {g} "
                         f"or n_iter={n_iter} do not fit the kernel's block "
                         f"({plan['smem']['total']} bytes of shared memory, "
                         f"at most {MAX_SMEM}; {len(plan['schedule'])} "
                         f"products a tile, at most {MAX_SEGS})")
    return plan
