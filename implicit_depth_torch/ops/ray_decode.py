"""Ray-major fused implicit decodes: stage 1 (kernel K1) and stage 2 (K4).

Counterpart of ``implicit_depth_tpu/ops/pallas_ray_decode.py``:

* :func:`ray_decode` — stage-1 per-pair decode (``fused_ray_decode``,
  ``xla_ray_decode``, ``_decode_rows``). The per_ray pair slots are t-sorted
  and front-packed, so decoding the first ``kb`` slots of every ray is a
  dense (N, kb) computation. Layer 1 of both decoders (IEF offset, IMNet
  termination probability) is split into a per-PAIR part over
  [vox | pos6 | trig] and a per-RAY part over [roi | dir_e], computed once
  per ray (``split_l1``). The positional encoding of the enter/leave points
  is never materialised: only its sin/cos columns (``trig``) are built from
  the raw positions, in the kernel. The kernel reads each pair's voxel row
  by its cell id from the (B·G³, Cv) voxel table instead of taking gathered
  (N·kb, Cv) rows. The kernels take every budget 1 <= kb <= :data:`MAX_KB`
  (:func:`rays_per_tile`), as the Pallas kernels take any kb.
* :func:`ief_decode` — stage-2 per-ray IEF decode (``fused_ief_rows``,
  ``xla_ief_rows``, ``_ief_rows``) over the embed parts [end | rc | pos_e];
  forward only, it refuses an operand that asks for a gradient.
  :func:`ief_decode_train` is the refine training's decode: K4 forward and,
  as ``fused_ief_rows``' VJP recomputes through ``xla_ief_rows``, autograd
  of the plain decode recomputed (:class:`IefDecodeTrain`).

Both IEF decoders hoist layer 1 out of the iterations and fold the 1 -> 16
offset encoder into a rank-1 update: (offset·enc_w + enc_b) @ W_x =
offset·a_vec + c_vec. Rounding follows ``_decode_rows`` / ``_ief_rows``:
every product takes compute-dtype operands with f32 accumulation; biases
1 and 4 add in f32, biases 2 and 3 are rounded to the compute dtype first;
each hidden activation is rounded to the compute dtype before its product.

Each wrapper runs the plain PyTorch version for CPU tensors and launches its
CUDA kernel (``csrc/ray_decode.cu``, ``csrc/ray_decode_bwd.cu``,
``csrc/ief_decode.cu``) for CUDA tensors, counting launches in
``<wrapper>.launches``. The ``global`` and dense stage-1 modes decode
through ``ops/pair_decode.py`` (K6). The kernels are compiled for the
decoder widths 4g-2g-g-1 of ``imnet_gf`` g in :data:`DECODER_GF`, read
from the weights as the Pallas kernels read theirs (:func:`decoder_gf`).
Any g from 1 to 128 runs at the next compiled width (:func:`compiled_gf`)
by padding the operands once, where they are made: the serving operands
(:func:`prep_ray_decode_weights`, :func:`prep_ief_weights`) and, on the
card, the training entries (:func:`ray_decode_train`,
:func:`ief_decode_train`), with zero units: a padded unit's pre-activation
is 0, LeakyReLU(0) = 0 and its row in the next layer is 0, so the outputs
are those of the narrower decoder. A voxel width (c_vox, c_end) is padded
to a multiple of :data:`VOX_MULTIPLE` the same way, with zero rows of
layer 1 and zero columns of the table (:func:`pad_columns`). The padding is
slicing, concatenation and ``F.pad``, so under autograd the pads'
gradients are dropped. :func:`decode_plan` mirrors the forward kernels'
tiles, shared memory and weight schedule on the host
(``csrc/decode_tile.cuh``), :func:`bwd_smem` K3's Pass A; the wrappers
refuse widths they are not given at, naming the limit.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict

import torch
import torch.nn.functional as F

from implicit_depth_torch.ops import cuda

LEAKY = 0.02
_PAD = 16  # kernels' K-dimension granule (bf16 tensor-core fragment depth)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _act(v):
    return torch.where(v > 0, v, LEAKY * v)


def soft_clamp(x):
    return torch.maximum(torch.minimum(x, 0.01 * x + 0.99), 0.01 * x)


def _squash(x, use_sigmoid: bool):
    return torch.sigmoid(x) if use_sigmoid else soft_clamp(x)


def _q(x, dtype):
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


def _dot(a, b, dtype):
    """a @ b with ``dtype`` operands and f32 accumulation."""
    return _q(a, dtype) @ _q(b, dtype)


def _pad_rows(w, rows):
    return torch.cat([w, w.new_zeros((rows - w.shape[0], *w.shape[1:]))], 0)


def _rank1(enc_w, enc_b, w_x, dtype):
    """a_vec, c_vec (4g,) f32 of the folded offset encoder."""
    return _dot(enc_w, w_x, dtype)[0], _dot(enc_b[None, :], w_x, dtype)[0]


def trig_block(pos6: torch.Tensor, multires: int) -> torch.Tensor:
    """(rows, 6) f32 [enter xyz | leave xyz] -> (rows, 12·multires) sin/cos
    columns of both positions' encodings, in embedder order per position:
    for each frequency j, [sin(x·2^j) (3) | cos(x·2^j) (3)]."""
    rows = pos6.shape[0]
    freqs = torch.tensor([2.0 ** j for j in range(multires)],
                         dtype=torch.float32, device=pos6.device)
    phase = torch.tensor([0.0, math.pi / 2], dtype=torch.float32,
                         device=pos6.device)
    p = pos6.float().reshape(rows, 2, 1, 1, 3)
    arg = p * freqs[:, None, None] + phase[:, None]         # (rows, 2, m, 2, 3)
    return torch.sin(arg).reshape(rows, 12 * multires)


# ---------------------------------------------------------------------------
# Stage 1: per-pair decode (K1)
# ---------------------------------------------------------------------------

def prep_ray_decode_weights(weights: Dict[str, torch.Tensor], c_vox: int,
                            c_roi: int, c_dir: int, multires: int,
                            dtype) -> Dict[str, torch.Tensor]:
    """The kernel operands (:func:`split_ray_decode_weights` at the kernels'
    widths, :func:`pad_ray_decode_operands`, cast by
    :func:`cast_ray_decode_operands`); the voxel table goes with them at
    ``pad_columns(table, w["dims"][0])``."""
    return cast_ray_decode_operands(pad_ray_decode_operands(
        split_ray_decode_weights(weights, c_vox, c_roi, c_dir, multires,
                                 dtype)), dtype)


_MATRICES = ("pair_w1", "ray_w1", "off_w2", "off_w3", "off_w4",
             "prob_w2", "prob_w3", "prob_w4")
_ROUNDED_BIASES = ("off_b2", "off_b3", "prob_b2", "prob_b3")


def cast_ray_decode_operands(w: Dict[str, torch.Tensor],
                             dtype) -> Dict[str, torch.Tensor]:
    """The f32 split operands as the kernels take them: matrices in
    ``dtype``, biases 2 and 3 rounded to ``dtype`` and held in f32."""
    out = dict(w)
    for k in _MATRICES:
        out[k] = w[k].to(dtype).contiguous()
    for k in _ROUNDED_BIASES:
        out[k] = _q(w[k], dtype)
    return out


def split_ray_decode_weights(weights: Dict[str, torch.Tensor], c_vox: int,
                             c_roi: int, c_dir: int, multires: int,
                             dtype) -> Dict[str, torch.Tensor]:
    """Split the decoder weights (JAX layout: off_enc_w/b, off_w1..4,
    off_b1..4, prob_w1..4, prob_b1..4; kernels (in, out)) into the kernel
    operands, all in f32. Layer 1's input layout is the embed [vox | roi |
    pe(enter) | pe(leave) | dir (| 16 offset-encoder rows for IEF)].

    Returns pair_w1 (KP, 2·4g) rows [vox | pos6 | trig | 0-pad] and ray_w1
    (CRP, 2·4g) rows [roi | dir | 0-pad], columns [off | prob]; b1 (2·4g,);
    a_vec, c_vec (4g,) of the offset encoder folded into layer 1 with
    ``dtype`` operands; and each decoder's layers 2-4. Only slicing,
    concatenation and the rank-1 fold: training differentiates through it,
    which lays the kernels' split gradients back onto the parameters."""
    c_pos = 6 * (1 + 2 * multires)
    half = c_pos // 2
    o1, o2, o3, o4 = c_vox, c_vox + c_roi, c_vox + c_roi + c_pos, \
        c_vox + c_roi + c_pos + c_dir

    def split(w1):
        pe = w1[o2:o3]
        pair = torch.cat([w1[:o1], pe[0:3], pe[half:half + 3],
                          pe[3:half], pe[half + 3:]], 0)
        ray = torch.cat([w1[o1:o2], w1[o3:o4]], 0)
        return pair, ray

    off_pair, off_ray = split(weights["off_w1"])
    prob_pair, prob_ray = split(weights["prob_w1"])
    kp = _round_up(c_vox + 6 + 12 * multires, _PAD)
    crp = _round_up(c_roi + c_dir, _PAD)
    a_vec, c_vec = _rank1(weights["off_enc_w"], weights["off_enc_b"],
                          weights["off_w1"][o4:], dtype)
    w = {
        "pair_w1": _pad_rows(torch.cat([off_pair, prob_pair], 1), kp).float(),
        "ray_w1": _pad_rows(torch.cat([off_ray, prob_ray], 1), crp).float(),
        "b1": torch.cat([weights["off_b1"], weights["prob_b1"]]).float(),
        "a_vec": a_vec, "c_vec": c_vec,
    }
    for p in ("off", "prob"):
        w[f"{p}_w2"], w[f"{p}_b2"], w[f"{p}_w3"], w[f"{p}_b3"] = (
            weights[f"{p}_{n}"].float() for n in ("w2", "b2", "w3", "b3"))
        w[f"{p}_w4"] = weights[f"{p}_w4"].reshape(-1).float()
        w[f"{p}_b4"] = weights[f"{p}_b4"].reshape(1).float()
    w["dims"] = (c_vox, c_roi + c_dir, multires)
    return w


def _mlp_tail(h1, w, prefix, dtype):
    """Layers 2-4 from the rounded layer-1 activation; returns (rows,) f32."""
    h2 = _act(_dot(h1, w[f"{prefix}w2"], dtype) + w[f"{prefix}b2"])
    h3 = _act(_dot(h2, w[f"{prefix}w3"], dtype) + w[f"{prefix}b3"])
    return _dot(h3, w[f"{prefix}w4"][:, None], dtype)[:, 0]


def _ief_loop(e1, w, prefix, n_iter, init_offset, dtype):
    offset = torch.full(e1.shape[:1], init_offset, dtype=torch.float32,
                        device=e1.device)
    for _ in range(n_iter):
        h1 = _act(e1 + offset[:, None] * w["a_vec"] + w["c_vec"])
        offset = offset + _mlp_tail(h1, w, prefix, dtype) + w[f"{prefix}b4"]
    return offset


def save_names(n_iter: int, mode: str = "l1") -> tuple:
    """The names of the training forward's saves, in the order of the JAX
    package's ``_save_layout``: 'l1' (``decode_bwd: kernel_save``) e1, z1p,
    trig; 'all' (``kernel_save_all``) also, per IEF iteration i, off{i} (the
    offset entering it), h2_{i}, h3_{i}, then off_fin, h2p, h3p, logit."""
    names = ("e1", "z1p", "trig")
    if mode == "all":
        for i in range(n_iter):
            names += (f"off{i}", f"h2_{i}", f"h3_{i}")
        names += ("off_fin", "h2p", "h3p", "logit")
    return names


def _saved_act(z, saved):
    """LeakyReLU of ``z`` whose value is the saved activation and whose
    slope comes from the saved activation's sign, as the JAX kernel's
    backward from full saves reads it (``dlrelu`` of the saved h)."""
    h = saved.float()
    slope = torch.where(h > 0, 1.0, LEAKY)
    return h + (z * slope - (z * slope).detach())


def ray_decode_plain(vox_table, cells, pos, ray_feat, w, *, n_iter=2,
                     init_offset=0.001, use_sigmoid=False, dtype=None,
                     saves=False, from_saves=None):
    """vox_table (S, Cv); cells (N, kb) int row ids into it; pos (N, kb, 6)
    f32 [enter | leave]; ray_feat (N, Cr) -> (offset, prob_logit), each
    (N, kb) f32 after the squash. ``dtype``: the compute dtype (default:
    that of ``w["pair_w1"]``, which may then hold f32 values).

    ``saves``: also return the tuple of what the saving forward writes for
    the backward (K3), named by :func:`save_names`: True (K2): e1
    (N·kb, 4g), the IEF layer-1 pre-activation before the offset term; z1p
    (N·kb, 4g), the probability decoder's layer-1 pre-activation; trig
    (N·kb, 12·multires), all in ``dtype``. 'all' (K2 'all'): also each IEF
    iteration's entering offset (N·kb, 1) f32 and its h2 (N·kb, g2), h3
    (N·kb, g3) in ``dtype``, the final offset and the logit before the
    squash (N·kb, 1) f32, and the probability decoder's h2p, h3p.
    ``from_saves``: either tuple, whose values replace the computed ones
    with the gradient flowing as through the computed ones: the function
    whose gradient K3 computes from those saves. e1, z1p, the offsets and
    the logit pass their gradient straight through; the saved h2 and h3
    also set the LeakyReLU slopes by their signs (as JAX's backward from
    full saves does); h1 is recomputed from the saved e1 and offset; trig
    is recomputed (the same sin block)."""
    dtype = dtype or w["pair_w1"].dtype
    n, kb = cells.shape
    c_vox, c_ray, multires = w["dims"]
    g4 = w["b1"].shape[0] // 2
    sv = {} if from_saves is None else dict(
        zip(save_names(n_iter, "all"), from_saves))

    def keep(x, name):  # x with the saved value, the gradient through
        if name not in sv:
            return x
        return x + (sv[name].float().reshape(x.shape) - x).detach()

    pos6 = pos.reshape(n * kb, 6).float()
    trig = _q(trig_block(pos6, multires), dtype)
    rows = vox_table[cells.reshape(-1).long()]
    # (float64: the table's gradient summed in float64 too)
    rows = rows.double() if dtype == torch.float64 else rows.float()
    x = torch.cat([_q(rows, dtype), _q(pos6, dtype), trig], 1)
    e1 = (_dot(x, w["pair_w1"][:x.shape[1]], dtype)
          + _dot(ray_feat, w["ray_w1"][:c_ray], dtype).repeat_interleave(kb, 0)
          + w["b1"])
    e1_off, z1p = keep(e1[:, :g4], "e1"), keep(e1[:, g4:], "z1p")
    acts = []

    def act(z, name):
        return _saved_act(z, sv[name]) if name in sv else _act(z)

    def tail(h1, p, tag):
        """Layers 2-4 of decoder ``p`` (as :func:`_mlp_tail`), h2 and h3
        from the saves named by ``tag`` where given."""
        h2 = act(_dot(h1, w[f"{p}w2"], dtype) + w[f"{p}b2"], f"h2{tag}")
        h3 = act(_dot(h2, w[f"{p}w3"], dtype) + w[f"{p}b3"], f"h3{tag}")
        acts.extend((h2, h3))
        return _dot(h3, w[f"{p}w4"][:, None], dtype)[:, 0]

    offset = torch.full(e1_off.shape[:1], init_offset, dtype=torch.float32,
                        device=e1_off.device)
    offs = []
    for i in range(n_iter):
        offset = keep(offset, f"off{i}")
        offs.append(offset)
        h1 = _act(e1_off + offset[:, None] * w["a_vec"] + w["c_vec"])
        offset = offset + tail(h1, "off_", f"_{i}") + w["off_b4"]
    offset = keep(offset, "off_fin")
    logit = keep(tail(_act(z1p), "prob_", "p") + w["prob_b4"], "logit")
    out = (_squash(offset, use_sigmoid).reshape(n, kb),
           _squash(logit, use_sigmoid).reshape(n, kb))
    if saves:
        q = lambda t: t.to(dtype)  # noqa: E731
        col = lambda t: t.float().reshape(-1, 1)  # noqa: E731
        out_saves = (q(e1_off), q(z1p), q(trig))
        if saves == "all":
            for i in range(n_iter):
                out_saves += (col(offs[i]), q(acts[2 * i]), q(acts[2 * i + 1]))
            out_saves += (col(offset), q(acts[-2]), q(acts[-1]), col(logit))
        out += (out_saves,)
    return out


# imnet_gf of the decoders the kernels are compiled for: layers 4g -> 2g ->
# g -> 1; every g up to the last is run at the next of them
DECODER_GF = cuda.DECODER_GF
MAX_GF = DECODER_GF[-1]


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


# -- padding to the compiled widths (exact: zero units, zero columns) --------

# the voxel width (c_vox, c_end) the operands are padded to a multiple of:
# K1, K2, K4 and K6 take a multiple of 8 in bf16 (16-byte rows), K3's
# d_rows product runs on the tensor cores at a multiple of 16 (another
# multiple of 8 takes CUDA-core FMA); one multiple, so one padded table
VOX_MULTIPLE = 16


def _pad_to(t, shape):
    """``t`` with zeros appended along each dimension up to ``shape``."""
    pads = []
    for have, want in zip(reversed(t.shape), reversed(shape)):
        pads += [0, want - have]
    return F.pad(t, pads) if any(pads) else t


def pad_columns(t, c):
    """The rows ``t`` (rows, c0) with zero columns appended up to ``c``:
    the voxel table or the end rows at their padded operands' width
    ``w["dims"][0]``. ``t`` itself where c0 == c."""
    return _pad_to(t, (t.shape[0], c))


def _halves(t, g4, to):
    """The last dimension [off (g4) | prob (g4)] of ``t`` with each half
    padded with zeros to ``to``."""
    h = t.reshape(*t.shape[:-1], 2, g4)
    return _pad_to(h, (*h.shape[:-1], to)).reshape(*t.shape[:-1], 2 * to)


def _pad_tails(w, prefixes, g, G):
    """Layers 2-4 of each decoder ``prefix`` of ``w`` padded from imnet_gf
    ``g`` to ``G``."""
    out = {}
    for p in prefixes:
        out[f"{p}w2"] = _pad_to(w[f"{p}w2"], (4 * G, 2 * G))
        out[f"{p}b2"] = _pad_to(w[f"{p}b2"], (2 * G,))
        out[f"{p}w3"] = _pad_to(w[f"{p}w3"], (2 * G, G))
        out[f"{p}b3"] = _pad_to(w[f"{p}b3"], (G,))
        out[f"{p}w4"] = _pad_to(w[f"{p}w4"], (G,))
    return out


def _insert_rows(w1, at, n_zero, rows):
    """``w1`` with ``n_zero`` zero rows inserted before row ``at`` (the
    columns a voxel width is padded by), its trailing zero rows then cut or
    padded to ``rows``."""
    if n_zero == 0 and w1.shape[0] == rows:
        return w1
    w = torch.cat([w1[:at], w1.new_zeros((n_zero, *w1.shape[1:])),
                   w1[at:]], 0)[:rows]
    return _pad_to(w, (rows, *w.shape[1:]))


def _contiguous(w):
    return {k: v.contiguous() if torch.is_tensor(v) else v
            for k, v in w.items()}


def pad_ray_decode_operands(w):
    """K1/K2/K3's operands ``w`` (the f32 split of
    :func:`split_ray_decode_weights`, or its cast) at the kernels' widths:
    the decoders padded to :func:`compiled_gf` with zero units, c_vox to a
    multiple of :data:`VOX_MULTIPLE` with zero voxel rows of pair_w1 (the
    table takes as many zero columns: :func:`pad_columns`). ``w`` itself
    where nothing is padded."""
    c_vox, c_ray, multires = w["dims"]
    g = w["b1"].shape[0] // 8
    G, cv = compiled_gf(g), _round_up(c_vox, VOX_MULTIPLE)
    if (g, c_vox) == (G, cv):
        return w
    kp = _round_up(cv + 6 + 12 * multires, _PAD)
    out = dict(w, dims=(cv, c_ray, multires))
    out["pair_w1"] = _halves(_insert_rows(w["pair_w1"], c_vox, cv - c_vox,
                                          kp), 4 * g, 4 * G)
    out["ray_w1"] = _halves(w["ray_w1"], 4 * g, 4 * G)
    out["b1"] = _halves(w["b1"], 4 * g, 4 * G)
    out["a_vec"] = _pad_to(w["a_vec"], (4 * G,))
    out["c_vec"] = _pad_to(w["c_vec"], (4 * G,))
    out.update(_pad_tails(w, ("off_", "prob_"), g, G))
    return _contiguous(out)


def _check_cuda(name, tensors, dtype):
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: all operands must be CUDA tensors")
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: compute dtype {dtype} not supported")


def _aligned(t):
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
# chunked layout and 16-row f32 blocks; bwd_rows' 16-row tiles).
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
        o = _align(o + size, 128)
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


def _f32_layout(kernel: str, m: int, kp: int, crp: int, g: int) -> dict:
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
        smem = _f32_layout(kernel, m, kp, crp, g)
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
def _check_plan(name, kernel, kp, crp, n_iter, is_bf16, n, g=64, kb=8):
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


def _decode_operands(name, vox_table, cells, pos, ray_feat, w):
    """Checks the K1/K2/K3 operands; returns them contiguous in the kernels'
    types."""
    dtype = w["pair_w1"].dtype
    n, kb = cells.shape
    c_vox, c_ray, multires = w["dims"]
    _check_cuda(name, [vox_table, cells, pos, ray_feat,
                       *(w[k] for k in _K1_WEIGHTS)], dtype)
    if not 1 <= kb <= MAX_KB:
        raise ValueError(f"{name} kernel takes 1 <= kb <= {MAX_KB} pair slots "
                         f"a ray (got kb={kb})")
    for p in ("off", "prob"):
        decoder_gf(name, w["b1"].shape[0] // 2, w[f"{p}_w2"].shape,
                   w[f"{p}_w3"].shape)
    if vox_table.shape[1] != c_vox or ray_feat.shape != (n, c_ray) \
            or pos.shape != (n, kb, 6):
        raise ValueError(f"{name}: operand shapes do not match the weights")
    return (_aligned(vox_table.to(dtype).contiguous()),
            cells.to(torch.int32).contiguous(), pos.float().contiguous(),
            _aligned(ray_feat.to(dtype).contiguous()))


def _ray_decode_cuda(vox_table, cells, pos, ray_feat, w, n_iter, init_offset,
                     use_sigmoid, saves=False):
    """K1; with ``saves`` True K2 (K1 that also writes e1, z1p and trig),
    with ``saves`` 'all' K2 'all' (also every IEF iteration's offset, h2,
    h3, the probability decoder's, and the pre-squash outputs)."""
    name = {False: "ray_decode", True: "ray_decode_save",
            "all": "ray_decode_save_all"}[saves]
    vox_table, cells, pos, ray_feat = _decode_operands(
        name, vox_table, cells, pos, ray_feat, w)
    dtype = w["pair_w1"].dtype
    n, kb = cells.shape
    c_vox, c_ray, multires = w["dims"]
    kp, crp = w["pair_w1"].shape[0], w["ray_w1"].shape[0]
    g = w["b1"].shape[0] // 8
    is_bf16 = dtype == torch.bfloat16
    if is_bf16 and c_vox % 8:
        raise ValueError(f"{name} kernel takes c_vox a multiple of 8 in "
                         f"bf16 (got {c_vox}; pad_ray_decode_operands pads "
                         "it)")
    _check_plan(name, "K2all" if saves == "all" else "K1", kp, crp, n_iter,
                is_bf16, n, g, kb)
    dev = cells.device
    off = torch.empty((n, kb), dtype=torch.float32, device=dev)
    logit = torch.empty_like(off)
    outs = [off, logit]
    if saves:
        g4 = w["b1"].shape[0] // 2
        outs += [torch.empty((n * kb, c), dtype=dtype, device=dev)
                 for c in (g4, g4, 12 * multires)]
    if saves == "all":
        # instance i < n_iter: IEF iteration i; n_iter: the final offset
        # and the probability decoder's activations
        rows, inst = n * kb, n_iter + 1
        outs += [torch.empty((inst, rows, 1), dtype=torch.float32, device=dev),
                 torch.empty((inst, rows, 2 * g), dtype=dtype, device=dev),
                 torch.empty((inst, rows, g), dtype=dtype, device=dev),
                 torch.empty((rows, 1), dtype=torch.float32, device=dev)]
    ptrs = cuda.ptr_array([vox_table, cells, pos, ray_feat,
                           *(w[k] for k in _K1_WEIGHTS), *outs])
    fn = cuda.bind("ray_decode", f"idt_{name}", cuda.PTR, *[cuda.I64] * 11,
                   cuda.F32)
    cuda.check(fn(ptrs, n, kb, c_vox, c_ray, multires, kp, crp, n_iter, g,
                  int(is_bf16), int(use_sigmoid), init_offset,
                  cuda.stream_ptr(dev)), name)
    if not saves:
        return off, logit
    saved = tuple(outs[2:5])
    if saves == "all":
        offs, h2s, h3s, logit_pre = outs[5:]
        for i in range(n_iter + 1):
            saved += (offs[i], h2s[i], h3s[i])
        saved += (logit_pre,)
    return off, logit, saved


_K1_WEIGHTS = ("pair_w1", "ray_w1", "b1", "a_vec", "c_vec",
               "off_w2", "off_b2", "off_w3", "off_b3", "off_w4", "off_b4",
               "prob_w2", "prob_b2", "prob_w3", "prob_b3", "prob_w4", "prob_b4")


def ray_decode(vox_table, cells, pos, ray_feat, w, *, n_iter=2,
               init_offset=0.001, use_sigmoid=False):
    """Stage-1 decode (see :func:`ray_decode_plain`); kernel K1 on CUDA."""
    if cells.device.type == "cpu":
        return ray_decode_plain(vox_table, cells, pos, ray_feat, w,
                                n_iter=n_iter, init_offset=init_offset,
                                use_sigmoid=use_sigmoid)
    out = _ray_decode_cuda(vox_table, cells, pos, ray_feat, w, n_iter,
                           init_offset, use_sigmoid)
    ray_decode.launches += 1
    return out


ray_decode.launches = 0


# ---------------------------------------------------------------------------
# Stage-1 training decode: saving forward (K2) and fused backward (K3)
# ---------------------------------------------------------------------------

def ray_decode_save(vox_table, cells, pos, ray_feat, w, *, n_iter=2,
                    init_offset=0.001, use_sigmoid=False):
    """The training forward: :func:`ray_decode` plus the saves of
    :func:`ray_decode_plain` (``saves=True``) -> (offset, logit, (e1, z1p,
    trig)). Kernel K2 on CUDA; the plain version on the CPU."""
    if cells.device.type == "cpu":
        return ray_decode_plain(vox_table, cells, pos, ray_feat, w,
                                n_iter=n_iter, init_offset=init_offset,
                                use_sigmoid=use_sigmoid, saves=True)
    out = _ray_decode_cuda(vox_table, cells, pos, ray_feat, w, n_iter,
                           init_offset, use_sigmoid, saves=True)
    ray_decode_save.launches += 1
    return out


ray_decode_save.launches = 0


def ray_decode_save_all(vox_table, cells, pos, ray_feat, w, *, n_iter=2,
                        init_offset=0.001, use_sigmoid=False):
    """The training forward of ``decode_bwd: kernel_save_all``:
    :func:`ray_decode` plus the full saves of :func:`ray_decode_plain`
    (``saves='all'``) -> (offset, logit, saves named by
    :func:`save_names`). Kernel K2 'all' on CUDA, where the saves of each
    name are slices of one buffer per kind; the plain version on the CPU."""
    if cells.device.type == "cpu":
        return ray_decode_plain(vox_table, cells, pos, ray_feat, w,
                                n_iter=n_iter, init_offset=init_offset,
                                use_sigmoid=use_sigmoid, saves="all")
    out = _ray_decode_cuda(vox_table, cells, pos, ray_feat, w, n_iter,
                           init_offset, use_sigmoid, saves="all")
    ray_decode_save_all.launches += 1
    return out


ray_decode_save_all.launches = 0


def ray_decode_bwd_plain(vox_table, cells, pos, ray_feat, w, g_off, g_logit,
                         *, n_iter=2, init_offset=0.001, use_sigmoid=False,
                         dtype=None, saved=None):
    """K3's function in plain PyTorch: autograd of :func:`ray_decode_plain`
    at the operands ``w`` (compute ``dtype``) -> (d_vox_table, d_ray_feat,
    {operand: gradient}), all f32 (float64 with ``dtype`` float64: every
    sum of the f32 function in float64, the yardstick against which f32
    sums in two orders are told apart). With ``saved`` (K2's e1, z1p, trig,
    or K2 'all''s full saves, :func:`save_names`) the decode starts from the
    saved values, as K3 does (``from_saves`` of :func:`ray_decode_plain`)."""
    ft = torch.float64 if dtype == torch.float64 else torch.float32
    with torch.enable_grad():
        leaves = {k: w[k].detach().to(ft).requires_grad_()
                  for k in _K1_WEIGHTS}
        vt = vox_table.detach().to(ft).requires_grad_()
        rf = ray_feat.detach().to(ft).requires_grad_()
        wq = {**w, **leaves}
        wq.update({k: _q(wq[k], dtype) for k in _ROUNDED_BIASES})
        off, logit = ray_decode_plain(
            vt, cells, pos, rf, wq, n_iter=n_iter, init_offset=init_offset,
            use_sigmoid=use_sigmoid, dtype=dtype, from_saves=saved)
        grads = torch.autograd.grad((off, logit), [vt, rf, *leaves.values()],
                                    (g_off.to(off.dtype), g_logit.to(off.dtype)))
    return grads[0], grads[1], dict(zip(leaves, grads[2:]))


# -- K3's plan: chunks of rays, operand streams, the weight-gradient products

# rays per chunk of the operand streams, at most; at kb > 8 pair slots a
# ray, at most the pair rows of kb 8's chunk of the same batch (bwd_plan)
K3_CHUNK_RAYS = 32768
K3_SPLIT_ROWS = 4096   # contraction rows of one Pass B block
K3_TILE = (64, 128)    # Pass B's output tile (gradient rows, columns)
# the operand streams Pass A writes, each (rows per instance, width): rows
# are a chunk's pair rows, or for the per-ray streams a row for each ray and
# tile of its slots (one a ray but at kb > rows_per_tile in f32)
K3_STREAMS = ("x", "de_off", "de_prob", "rf", "dre_off", "dre_prob",
              "h1", "dt2", "h2", "dt3")
_PER_RAY_STREAMS = ("rf", "dre_off", "dre_prob")
_TAIL_STREAMS = ("h1", "dt2", "h2", "dt3")
# the gradients Pass A sums per block (f32, in shared memory), in order
K3_SMALL = ("b1", "a_vec", "c_vec", "off_b2", "off_b3", "off_w4", "off_b4",
            "prob_b2", "prob_b3", "prob_w4", "prob_b4")


def k3_jobs(g: int = 64) -> tuple:
    """Pass B's products at imnet_gf ``g``: (gradient, column offset in it,
    A stream, B stream, IEF instances (else the probability decoder's,
    instance 0))."""
    return (("pair_w1", 0, "x", "de_off", False),
            ("pair_w1", 4 * g, "x", "de_prob", False),
            ("ray_w1", 0, "rf", "dre_off", False),
            ("ray_w1", 4 * g, "rf", "dre_prob", False),
            ("off_w2", 0, "h1", "dt2", True),
            ("prob_w2", 0, "h1", "dt2", False),
            ("off_w3", 0, "h2", "dt3", True),
            ("prob_w3", 0, "h2", "dt3", False))


K3_JOBS = k3_jobs()  # at the default widths
_PLAN_HEADER = 40   # int64 fields before the jobs (see csrc/ray_decode_bwd.cu)
_JOB_FIELDS, _RED_FIELDS = 12, 9


def _align(x: int, a: int = 64) -> int:
    return -(-x // a) * a


def bwd_grad_layout(kp: int, crp: int, g: int = 64) -> Dict[str, tuple]:
    """{operand: (float offset, shape)} of each weight gradient in K3's f32
    output (decoders of imnet_gf ``g``), in the operand order of K1/K2,
    each at a 64-float boundary; ``"total"``: (its size, ())."""
    g1, g2, g3 = 4 * g, 2 * g, g
    shapes = {"pair_w1": (kp, 2 * g1), "ray_w1": (crp, 2 * g1),
              "b1": (2 * g1,), "a_vec": (g1,), "c_vec": (g1,)}
    for p in ("off", "prob"):
        shapes.update({f"{p}_w2": (g1, g2), f"{p}_b2": (g2,),
                       f"{p}_w3": (g2, g3), f"{p}_b3": (g3,),
                       f"{p}_w4": (g3,), f"{p}_b4": (1,)})
    out, off = {}, 0
    for k in _K1_WEIGHTS:
        out[k] = (off, shapes[k])
        off = _align(off + math.prod(shapes[k]))
    out["total"] = (off, ())
    return out


def bwd_plan(n: int, kp: int, crp: int, n_iter: int, is_bf16: bool,
             sm_count: int, chunk_rays: int = K3_CHUNK_RAYS,
             split_rows: int = K3_SPLIT_ROWS, table_elems: int = 0,
             g: int = 64, kb: int = 8, c_vox: int = 0) -> dict:
    """The host-side arithmetic of K3 for ``n`` rays of ``kb`` pairs, a
    voxel table of ``table_elems`` elements (rows x ``c_vox``) and decoders
    of imnet_gf ``g`` (Pass B's tiles are K3_TILE at every width: a narrow
    gradient fills part of its one tile column, the rest of the partial is
    padding that no reduction reads).

    Pass A walks the rays in ``n_chunks`` chunks, equal but for the last,
    of whole tiles of rays: at most ``chunk_rays`` rays, and at most the
    pair rows of the chunks kb 8 takes at this batch, so that K3's scratch
    at any kb is no larger than kb 8's. A tile of ``rows_per_tile`` pair
    rows (:func:`bwd_rows`: 64 in bf16 where Pass A's block fits, else 32,
    else 16) holds ``rays_per_tile`` whole rays or, at kb > its rows, a
    ray's slots spread over ``tiles_per_ray`` tiles
    (:func:`tile_rows`). Pass A runs on a persistent grid of ``blocks_a``
    blocks and writes each weight gradient's operands into the streams
    (``streams``: {name: (element offset, rows per instance, width,
    instances)} in one scratch buffer of the compute type, reused by every
    chunk). Pass B then forms each gradient product of ``jobs`` over the
    chunk as split-K tiles of K3_TILE: split s of a job covers rows [s·split
    rows, ...) of one instance, and adds its tile into its own f32 partial,
    so that every partial is summed in one order. The reductions ``reds``
    sum the partials, and the per-block sums of the small gradients
    (``small``), in a fixed order into the output (:func:`bwd_grad_layout`).
    Each Pass A block also adds its tiles' d_vox_table rows into a table of
    its own (``table_stride`` floats a block from ``table_off``, across the
    chunks), and a last reduction sums those in block order: d_vox_table is
    bit-identical run to run, as the weight gradients are.
    """
    if n < 1 or chunk_rays < 1 or split_rows < 1 or n_iter < 1:
        raise ValueError("bwd_plan: empty or invalid sizes")
    if g not in DECODER_GF:
        raise ValueError(f"bwd_plan: imnet_gf g in {DECODER_GF} (got {g})")
    if not 1 <= kb <= MAX_KB:
        raise ValueError(f"bwd_plan: kb in [1, {MAX_KB}] (got {kb})")
    g1, g2, g3 = 4 * g, 2 * g, g
    layout = bwd_grad_layout(kp, crp, g)
    small, s_off = {}, 0
    for k in K3_SMALL:
        small[k] = s_off
        s_off = _align(s_off + math.prod(layout[k][1]), 4)
    m = bwd_rows(kp, crp, c_vox, n_iter, s_off, g, is_bf16)
    mr = rays_per_tile(kb, m, max(4, m // 8))
    tpr = -(-kb // m)
    # the rays of kb 8's chunk at this batch (its tiles: m // 8 rays)
    chunk8 = _align(-(-n // -(-n // chunk_rays)), m // 8)
    limit = max(mr, min(chunk_rays, chunk8 * 8 // kb) // mr * mr)
    n_chunks = -(-n // limit)
    chunk = _align(-(-n // n_chunks), mr)
    n_chunks = -(-n // chunk)
    n_inst = n_iter + 1
    rows = chunk * kb
    widths = {"x": kp, "de_off": g1, "de_prob": g1, "rf": crp,
              "dre_off": g1, "dre_prob": g1, "h1": g1, "dt2": g2,
              "h2": g2, "dt3": g3}
    streams, off = {}, 0
    for name in K3_STREAMS:
        r = chunk * tpr if name in _PER_RAY_STREAMS else rows
        inst = n_inst if name in _TAIL_STREAMS else 1
        streams[name] = (off, r, widths[name], inst)
        off = _align(off + r * widths[name] * inst)
    scratch = off
    jobs, reds, p_off, blocks_b = [], [], 0, 0
    tk_rows, tn_cols = K3_TILE
    for grad, col, a, b, ief in k3_jobs(g):
        _, r, kw, _ = streams[a]
        nw = streams[b][2]
        tiles_k, tiles_n = -(-kw // tk_rows), -(-nw // tn_cols)
        inst0, n_inst_job = (1, n_iter) if ief else (0, 1)
        spi = -(-r // split_rows)
        splits = n_inst_job * spi
        ld_src = tiles_n * tn_cols
        stride = tiles_k * tk_rows * ld_src
        jobs.append({"a": a, "b": b, "inst0": inst0, "n_inst": n_inst_job,
                     "tiles_k": tiles_k, "tiles_n": tiles_n,
                     "splits_per_inst": spi, "p_off": p_off,
                     "block0": blocks_b})
        g_off, shape = layout[grad]
        reds.append({"src": p_off, "stride": stride, "dst": g_off + col,
                     "splits": splits, "k": kw, "n": nw, "ld_src": ld_src,
                     "ld_dst": shape[1]})
        p_off += splits * stride
        blocks_b += tiles_k * tiles_n * splits
    tiles = -(-chunk // mr) * tpr
    # Pass A's blocks (one an SM): at 64 rows (wgmma) each holds
    # K3_WG_SLOTS tiles, and blocks_a counts those slots
    slots = K3_WG_SLOTS if m == 64 else 1
    blocks_a = max(1, min(slots * sm_count, -(-chunk // mr)))
    for k in K3_SMALL:
        size = math.prod(layout[k][1])
        reds.append({"src": p_off + small[k], "stride": s_off,
                     "dst": layout[k][0], "splits": blocks_a, "k": 1,
                     "n": size, "ld_src": size, "ld_dst": size})
    table_off = _align(p_off + blocks_a * s_off)
    table_stride = _align(table_elems)
    return {"rows_per_tile": m, "kb": kb, "rays_per_tile": mr,
            "pass_a": "wgmma" if m == 64 else "wmma",
            "smem_a": bwd_smem(m, g, crp, n_iter, s_off, is_bf16),
            "tile_slots": slots,
            "tiles_per_ray": tpr, "chunk_rays": chunk, "n_chunks": n_chunks,
            "tiles_per_chunk": tiles, "blocks_a": blocks_a,
            "n_inst": n_inst, "split_rows": split_rows, "streams": streams,
            "scratch_elems": scratch, "jobs": jobs, "blocks_b": blocks_b,
            "small": small, "small_size": s_off, "small_off": p_off,
            "table_off": table_off, "table_stride": table_stride,
            "table_elems": table_elems,
            "partial_floats": table_off + blocks_a * table_stride,
            "reds": reds, "grad_floats": layout["total"][0]}


K3_STAGE_ELEMS = 2 * 128 * (64 + 8)  # Pass A's weight slabs (kStageElems)
# the 64-row Pass A (csrc/ray_decode_bwd_wg.cuh): the tiles a block holds
# (kSlotsW), the ring of weight slabs they share (bf16 elements: wgmma.cuh
# kSlabs of kSlabElems) and F's row stride (kLdF)
K3_WG_SLOTS, K3_WG_SLABS, K3_WG_LDF = 2, 3 * 4096, 68


def bwd_smem(m: int, g: int, crp: int, n_iter: int, small_size: int,
             is_bf16: bool) -> int:
    """Bytes of dynamic shared memory of one K3 Pass A block of ``m`` rows
    (64, 32 or 16) at imnet_gf ``g``, per-ray width ``crp``, ``n_iter`` IEF
    iterations and ``small_size`` floats of small sums: WgSmem (64 rows,
    ``csrc/ray_decode_bwd_wg.cuh``: K3_WG_SLOTS tiles' regions and the
    weight slabs they share) or BwdSmem (``csrc/ray_decode_bwd.cu``). At 64
    rows X (kp <= 400) spans the H1 and H2 tiles and the d_rows pieces hold
    c_vox <= 256; at 32 and 16 rows kp <= 640, c_vox <= 512. The per-ray
    regions hold max(4, m / 8) rays."""
    es = 2 if is_bf16 else 4
    g1, g2, g3 = 4 * g, 2 * g, g
    ld1, ld2, ld3 = g1 + 8, g2 + 8, g3 + 8
    max_kp, max_cvox = (400, 256) if m == 64 else (640, 512)
    mr = max(4, m // 8)
    a = lambda b: _align(b, 128)  # noqa: E731
    o = a(m * max(ld1, max_kp - ld2) * es)             # H1 | X
    o = a(o + m * ld2 * es)                             # H2
    o = a(o + m * ld3 * es)                             # H3
    if m == 64:
        o = a(o + m * K3_WG_LDF * 4) + 6 * m * 4        # F, doff .. next
    else:
        o = a(o + max(m * g2 * 4, m * ld1 * es))            # C
        o = a(o + m * max(g1, max_cvox) * 4)                # D
        o = a(o + (K3_STAGE_ELEMS * es if is_bf16 else 0))  # weight slabs
        for _ in range(7):                                  # doff .. next
            o = a(o + m * 4)
        o = a(o + g1 * 4)                                   # a_vec
        o = a(o + g1 * 4)                                   # c_vec
        o = a(o + mr * ld1 * es)                            # RET
    o = a(o + (n_iter + 1) * m * 4)                     # offsets
    o = a(o + mr * crp * es)                            # RF
    if m == 64:  # d_ray_feat's sums lie in the global scratch
        return K3_WG_SLOTS * a(o + small_size * 4) + K3_WG_SLABS * 2
    o = a(o + mr * crp * 4)                             # DRF
    return a(o + small_size * 4)


def bwd_held(m: int, g: int, is_bf16: bool) -> bool:
    """Whether K3's libraries hold a Pass A instance of ``m`` rows
    (``csrc/ray_decode_bwd.cu::held``): 64 rows in bf16 at imnet_gf <= 64;
    32 rows but in f32 at 128 (that block never fits); 16 rows in f32 and
    in bf16 at 128 (at <= 64 the 32-row bf16 block holds every width the
    wrapper takes)."""
    return {64: is_bf16 and g <= 64, 32: is_bf16 or g <= 64,
            16: not is_bf16 or g == 128}[m]


def bwd_rows(kp: int, crp: int, c_vox: int, n_iter: int, small_size: int,
             g: int, is_bf16: bool) -> int:
    """K3's Pass A tile rows: the first of 64, 32 and 16 whose block the
    libraries hold (:func:`bwd_held`) and fits (64: kp <= 400, c_vox <=
    256; :func:`bwd_smem`); raises past the limits, naming them."""
    if kp > MAX_KP["K3"] or c_vox > MAX_CVOX or crp > MAX_CRP:
        raise ValueError(f"ray_decode_bwd kernel takes kp up to "
                         f"{MAX_KP['K3']}, c_vox up to {MAX_CVOX} and crp up "
                         f"to {MAX_CRP} (got kp={kp}, c_vox={c_vox}, "
                         f"crp={crp})")
    for m in (64, 32, 16):
        if m == 64 and (kp > 400 or c_vox > 256):
            continue
        size = bwd_smem(m, g, crp, n_iter, small_size, is_bf16)
        if bwd_held(m, g, is_bf16) and size <= MAX_SMEM:
            return m
    raise ValueError(f"ray_decode_bwd: widths kp={kp}, c_vox={c_vox}, "
                     f"crp={crp}, imnet_gf {g} do not fit Pass A ({size} "
                     f"bytes of shared memory at 16 rows, at most "
                     f"{MAX_SMEM})")


def bwd_scratch_bytes(plan: dict, elem_bytes: int) -> int:
    """K3's scratch beyond its outputs: the streams and the f32 partials."""
    return plan["scratch_elems"] * elem_bytes + plan["partial_floats"] * 4


def pack_bwd_plan(plan: dict) -> list:
    """The plan as the int64 array idt_ray_decode_bwd reads."""
    hdr = [plan["chunk_rays"], plan["n_chunks"], plan["blocks_a"],
           plan["rows_per_tile"], plan["n_inst"], plan["split_rows"],
           len(plan["jobs"]), len(plan["reds"])]
    hdr += [plan["streams"][k][0] for k in K3_STREAMS]
    hdr += [plan["small"][k] for k in K3_SMALL]
    hdr += [plan["small_size"], plan["small_off"], plan["scratch_elems"],
            plan["partial_floats"], plan["blocks_b"], plan["table_off"],
            plan["table_stride"], plan["table_elems"], plan["kb"],
            plan["rays_per_tile"], plan["tiles_per_ray"]]
    hdr += [0] * (_PLAN_HEADER - len(hdr))
    out = hdr
    for j in plan["jobs"]:
        out += [K3_STREAMS.index(j["a"]), K3_STREAMS.index(j["b"]),
                j["inst0"], j["n_inst"], j["tiles_k"], j["tiles_n"],
                j["splits_per_inst"], j["p_off"], j["block0"], 0, 0, 0]
    for r in plan["reds"]:
        out += [r["src"], r["stride"], r["dst"], r["splits"], r["k"],
                r["n"], r["ld_src"], r["ld_dst"], 0]
    return out


def ray_decode_bwd(vox_table, cells, pos, ray_feat, w, saved, g_off, g_logit,
                   *, n_iter=2, init_offset=0.001, use_sigmoid=False):
    """Kernel K3 (see :func:`_ray_decode_bwd_cuda`), counted in
    ``ray_decode_bwd.launches``, and in ``ray_decode_bwd.wgmma_launches``
    where its Pass A ran the 64-row wgmma instance (the plan's ``pass_a``)."""
    taken = {}
    out = _ray_decode_bwd_cuda(vox_table, cells, pos, ray_feat, w, saved,
                               g_off, g_logit, n_iter=n_iter,
                               init_offset=init_offset,
                               use_sigmoid=use_sigmoid, taken=taken)
    ray_decode_bwd.launches += 1
    ray_decode_bwd.wgmma_launches += int(taken.get("pass_a") == "wgmma")
    return out


def ray_decode_bwd_pass_ms(*args, **kw) -> dict:
    """Measurement: one K3 call on ``args``/``kw`` as :func:`ray_decode_bwd`
    takes them, with CUDA events recorded by the C function between its
    passes (not counted as a launch of the main path). Returns the device
    ms of Pass A and of Pass B, each summed over the chunks, of the final
    reduction, and the plan's scratch bytes."""
    holder = {}
    _ray_decode_bwd_cuda(*args, **kw, events=holder)
    torch.cuda.synchronize()
    ev, n_chunks = holder["events"], holder["plan"]["n_chunks"]
    ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(len(ev) - 1)]
    return {"pass_a_ms": sum(ms[0:2 * n_chunks:2]),
            "pass_b_ms": sum(ms[1:2 * n_chunks:2]),
            "reduce_ms": ms[2 * n_chunks], "chunks": n_chunks,
            "scratch_bytes": holder["scratch_bytes"]}


def _stacked(ts):
    """The equal-shaped contiguous tensors ``ts`` as one (len, ...) tensor:
    a view where they lie one after another in one buffer (as K2 'all'
    writes its saves), else a copy."""
    t0, step = ts[0], ts[0].numel() * ts[0].element_size()
    if all(t.is_contiguous() and t.shape == t0.shape and t.dtype == t0.dtype
           and t.untyped_storage().data_ptr()
           == t0.untyped_storage().data_ptr()
           and t.data_ptr() == t0.data_ptr() + i * step
           for i, t in enumerate(ts)):
        return t0.as_strided((len(ts), *t0.shape),
                             (t0.numel(), *t0.stride()))
    return torch.stack([t.contiguous() for t in ts])


def _bwd_saves(saved, n, kb, g4, multires, n_iter, dtype, dev):
    """K3's save operands: (e1, z1p, trig) and, for full saves, the offsets
    (n_iter + 1, N·kb, 1) f32, h2 (n_iter + 1, N·kb, g4 / 2), h3 and the
    logit
    (N·kb, 1) f32 (instance n_iter: the final offset and the probability
    decoder's); None where the instance does not read them."""
    if saved is None:
        return (None,) * 7
    kinds = {len(save_names(n_iter, m)): m for m in ("l1", "all")}
    if len(saved) not in kinds:
        raise ValueError("ray_decode_bwd: saves are neither K2's nor K2 "
                         "'all''s")
    sv = dict(zip(save_names(n_iter, kinds[len(saved)]), saved))
    for name, t in sv.items():
        # the offsets and the logit are f32 columns
        c, dt = {"e1": (g4, dtype), "z1p": (g4, dtype),
                 "trig": (12 * multires, dtype), "h2": (g4 // 2, dtype),
                 "h3": (g4 // 4, dtype)}.get(
                     name[:2] if name[0] == "h" else name, (1, torch.float32))
        if t.shape != (n * kb, c) or t.dtype != dt or t.device != dev:
            raise ValueError(f"ray_decode_bwd: save {name} does not match "
                             "the operands")
    out = tuple(sv[k].contiguous() for k in ("e1", "z1p", "trig"))
    if len(sv) == 3:
        return out + (None,) * 4
    its = range(n_iter)
    return out + (
        _stacked([*(sv[f"off{i}"] for i in its), sv["off_fin"]]),
        _stacked([*(sv[f"h2_{i}"] for i in its), sv["h2p"]]),
        _stacked([*(sv[f"h3_{i}"] for i in its), sv["h3p"]]),
        sv["logit"].contiguous())


def _ray_decode_bwd_cuda(vox_table, cells, pos, ray_feat, w, saved, g_off,
                         g_logit, *, n_iter=2, init_offset=0.001,
                         use_sigmoid=False, events=None, taken=None):
    """Kernel K3: gradients of the stage-1 decode, from K2's saves, from K2
    'all''s full saves (``decode_bwd='kernel_save_all'``: no forward
    product) or, with ``saved=None``, recomputing layer 1
    (``decode_bwd='kernel'``).

    ``w`` are the kernel operands (:func:`cast_ray_decode_operands`);
    ``saved`` = (e1, z1p, trig) from :func:`ray_decode_save`, the full saves
    from :func:`ray_decode_save_all`, or None; g_off, g_logit (N, kb) the
    cotangents of its outputs. Its plain version is
    :func:`ray_decode_bwd_plain` with the same ``saved``. Returns
    (d_vox_table (S, Cv), d_ray_feat (N, Cr), {operand: gradient in the
    operand's shape}), all f32. One C call runs the passes of
    :func:`bwd_plan` chunk by chunk (``events``: a dict that receives the
    CUDA events it records between them, for measurement); every gradient,
    d_vox_table too, is summed in a fixed order (bit-identical run to
    run). ``taken``: a dict that receives the plan's Pass A instance under
    ``"pass_a"`` when the kernel runs."""
    vox_table, cells, pos, ray_feat = _decode_operands(
        "ray_decode_bwd", vox_table, cells, pos, ray_feat, w)
    dtype = w["pair_w1"].dtype
    n, kb = cells.shape
    c_vox, c_ray, multires = w["dims"]
    g4 = w["b1"].shape[0] // 2
    dev = cells.device
    saves = _bwd_saves(saved, n, kb, g4, multires, n_iter, dtype, dev)
    kp, crp = w["pair_w1"].shape[0], w["ray_w1"].shape[0]
    if c_vox % 8 or c_vox > MAX_CVOX or kp > MAX_KP["K3"] or crp > MAX_CRP:
        raise ValueError(f"ray_decode_bwd kernel takes c_vox up to "
                         f"{MAX_CVOX} (a multiple of 8), kp up to "
                         f"{MAX_KP['K3']} and crp up to {MAX_CRP} (got "
                         f"c_vox={c_vox}, kp={kp}, crp={crp})")
    g = torch.stack([g_off.float(), g_logit.float()], -1).contiguous()
    if g.shape != (n, kb, 2):
        raise ValueError("ray_decode_bwd: cotangents must be (N, kb)")
    kp, crp = w["pair_w1"].shape[0], w["ray_w1"].shape[0]
    layout = bwd_grad_layout(kp, crp, g4 // 4)
    d_w = torch.empty((layout["total"][0],), dtype=torch.float32, device=dev)
    d_table = torch.empty(vox_table.shape, dtype=torch.float32, device=dev)
    d_rf = torch.empty((n, c_ray), dtype=torch.float32, device=dev)
    if n > 0:
        plan = bwd_plan(n, kp, crp, n_iter, dtype == torch.bfloat16,
                        cuda.sm_count(dev), K3_CHUNK_RAYS, K3_SPLIT_ROWS,
                        vox_table.numel(), g4 // 4, kb, c_vox)
        packed = pack_bwd_plan(plan)
        scratch = torch.empty((plan["scratch_elems"],), dtype=dtype,
                              device=dev)
        partials = torch.empty((plan["partial_floats"],),
                               dtype=torch.float32, device=dev)
        # each block's f32 slice: the recompute instance's e1 tile; at 64
        # rows the IEF's d_z1, the recompute's z1p, e1 and per-ray layer 1,
        # and d_ray_feat's sums (csrc/ray_decode_bwd_wg.cuh
        # wg_scratch_floats)
        wgmma = plan["pass_a"] == "wgmma"
        per_block = ((64 if saved is not None else 144) * g4 + 8 * crp
                     if wgmma else plan["rows_per_tile"] * g4)
        slots = plan["tile_slots"]  # every slot of the last block
        e1_scratch = None if saved is not None and not wgmma else \
            torch.empty((-(-plan["blocks_a"] // slots) * slots, per_block),
                        dtype=torch.float32, device=dev)
        ptrs = cuda.ptr_array([vox_table, cells, pos, ray_feat,
                               *(w[k] for k in _K1_WEIGHTS), *saves[:3], g,
                               d_table, d_rf, d_w, scratch, partials,
                               e1_scratch, *saves[3:]])
        ev = None
        if events is not None:  # measurement: events between the passes
            marks = [torch.cuda.Event(enable_timing=True)
                     for _ in range(2 * plan["n_chunks"] + 2)]
            for e in marks:  # creates each event's CUDA handle
                e.record()
            ev = (ctypes.c_void_p * len(marks))(
                *(e.cuda_event for e in marks))
            events.update(events=marks, plan=plan,
                          scratch_bytes=bwd_scratch_bytes(
                              plan, scratch.element_size()))
        fn = cuda.bind(f"ray_decode_bwd_g{g4 // 4}", "idt_ray_decode_bwd",
                       cuda.PTR, cuda.PTR, *[cuda.I64] * 11, cuda.F32,
                       cuda.PTR)
        if taken is not None:
            taken["pass_a"] = plan["pass_a"]
        cuda.check(fn(ptrs, (cuda.I64 * len(packed))(*packed), len(packed),
                      n, c_vox, c_ray, multires, kp, crp, n_iter, g4 // 4,
                      int(dtype == torch.bfloat16), int(use_sigmoid),
                      init_offset, ev, cuda.stream_ptr(dev)),
                   "ray_decode_bwd")
    else:
        d_w.zero_()
        d_table.zero_()
    grads = {k: d_w[o:o + math.prod(shape)].view(shape)
             for k, (o, shape) in layout.items() if k != "total"}
    return d_table, d_rf, grads


ray_decode_bwd.launches = 0
ray_decode_bwd.wgmma_launches = 0

DECODE_BWD_MODES = ("kernel_save", "kernel", "kernel_save_all", "xla")


class RayDecodeTrain(torch.autograd.Function):
    """The training decode on the card, by ``decode_bwd``:

    * 'kernel_save': forward K2, backward K3 from its saves;
    * 'kernel_save_all': forward K2 'all', backward K3 from its full saves
      (no forward product is recomputed);
    * 'kernel': forward K1 (no saves), backward K3 recomputing layer 1;
    * 'xla': forward K1, backward autograd through :func:`ray_decode_plain`
      (:func:`ray_decode_bwd_plain` with ``saved=None``). This is the
      counterpart of the JAX package's 'xla' mode, whose backward is XLA
      autograd of ``xla_ray_decode`` and runs no kernel: the one place on a
      card path where the plain decode runs, by design, not as a stand-in.

    Takes the f32 split operands (:func:`split_ray_decode_weights`) and
    casts them inside, so that their gradients reach the f32 parameters
    unrounded; ``cells`` and ``pos`` get no gradient (geometry, as in the
    JAX package)."""

    @staticmethod
    def forward(ctx, opts, vox_table, cells, pos, ray_feat, *ops):
        dtype, dims, n_iter, init_offset, use_sigmoid, decode_bwd = opts
        w32 = dict(zip(_K1_WEIGHTS, ops), dims=dims)
        w = cast_ray_decode_operands(w32, dtype)
        kw = dict(n_iter=n_iter, init_offset=init_offset,
                  use_sigmoid=use_sigmoid)
        if decode_bwd == "kernel_save":
            off, logit, saved = ray_decode_save(vox_table, cells, pos,
                                                ray_feat, w, **kw)
        elif decode_bwd == "kernel_save_all":
            off, logit, saved = ray_decode_save_all(vox_table, cells, pos,
                                                    ray_feat, w, **kw)
        else:
            (off, logit), saved = ray_decode(vox_table, cells, pos, ray_feat,
                                             w, **kw), ()
        ctx.opts = opts
        ctx.in_dtypes = (vox_table.dtype, ray_feat.dtype)
        ctx.save_for_backward(vox_table, cells, pos, ray_feat,
                              *(w[k] for k in _K1_WEIGHTS), *saved)
        return off, logit

    @staticmethod
    def backward(ctx, g_off, g_logit):
        dtype, dims, n_iter, init_offset, use_sigmoid, decode_bwd = ctx.opts
        vox_table, cells, pos, ray_feat, *rest = ctx.saved_tensors
        w = dict(zip(_K1_WEIGHTS, rest), dims=dims)
        saved = tuple(rest[len(_K1_WEIGHTS):]) or None
        kw = dict(n_iter=n_iter, init_offset=init_offset,
                  use_sigmoid=use_sigmoid)
        if decode_bwd == "xla":
            d_table, d_rf, d_w = ray_decode_bwd_plain(
                vox_table, cells, pos, ray_feat, w, g_off, g_logit,
                dtype=dtype, **kw)
        else:
            d_table, d_rf, d_w = ray_decode_bwd(
                vox_table, cells, pos, ray_feat, w, saved, g_off, g_logit,
                **kw)
        return (None, d_table.to(ctx.in_dtypes[0]), None, None,
                d_rf.to(ctx.in_dtypes[1]), *(d_w[k] for k in _K1_WEIGHTS))


def ray_decode_train(vox_table, cells, pos, ray_feat, w32, dtype, *,
                     n_iter=2, init_offset=0.001, use_sigmoid=False,
                     decode_bwd="kernel_save"):
    """Differentiable stage-1 decode of the training step.

    ``w32``: the f32 split operands from live parameters
    (:func:`split_ray_decode_weights`, never the serving cache). CPU tensors
    take plain autograd through :func:`ray_decode_plain` (every
    ``decode_bwd`` mode); CUDA tensors take :class:`RayDecodeTrain`, which
    implements each of ``DECODE_BWD_MODES``, at the kernels' widths: the
    operands and the table are padded here, under autograd, which drops
    the pads' gradients."""
    if decode_bwd not in DECODE_BWD_MODES:
        raise ValueError(f"decode_bwd {decode_bwd!r}")
    if cells.device.type == "cpu":
        w = {**w32, **{k: _q(w32[k], dtype) for k in _ROUNDED_BIASES}}
        return ray_decode_plain(vox_table, cells, pos, ray_feat, w,
                                n_iter=n_iter, init_offset=init_offset,
                                use_sigmoid=use_sigmoid, dtype=dtype)
    w32 = pad_ray_decode_operands(w32)
    vox_table = pad_columns(vox_table, w32["dims"][0])
    return RayDecodeTrain.apply(
        (dtype, w32["dims"], n_iter, init_offset, use_sigmoid, decode_bwd),
        vox_table, cells, pos, ray_feat, *(w32[k] for k in _K1_WEIGHTS))


# ---------------------------------------------------------------------------
# Stage 2: per-ray IEF decode (K4)
# ---------------------------------------------------------------------------

def split_ief_weights(weights: Dict[str, torch.Tensor], c_end: int,
                      c_rc: int, c_pos: int, c_dir: int,
                      dtype) -> Dict[str, torch.Tensor]:
    """Split the refine IEF weights (JAX layout enc_w/enc_b, w1..w4, b1..b4)
    over the stage-2 embed [end | roi | pos_e | dir_e | enc(16)] into the
    kernel operands, all in f32: w1 (KP, 4g) rows [end | rc = (roi, dir) |
    pos | 0-pad], b1, a_vec, c_vec (the offset encoder folded into layer 1
    with ``dtype`` operands) and layers 2-4. Only slicing, concatenation
    and the rank-1 fold: the training decode differentiates through it,
    which lays the split gradients back onto the parameters."""
    w1 = weights["w1"]
    o1 = c_end
    o2 = o1 + (c_rc - c_dir)
    o3 = o2 + c_pos
    o4 = o3 + c_dir
    kp = _round_up(c_end + c_rc + c_pos, _PAD)
    a_vec, c_vec = _rank1(weights["enc_w"], weights["enc_b"], w1[o4:], dtype)
    w = {"w1": _pad_rows(torch.cat([w1[:o1], w1[o1:o2], w1[o3:o4], w1[o2:o3]],
                                   0), kp).float(),
         "b1": weights["b1"].float(), "a_vec": a_vec, "c_vec": c_vec}
    for n in ("w2", "b2", "w3", "b3"):
        w[n] = weights[n].float()
    w["w4"] = weights["w4"].reshape(-1).float()
    w["b4"] = weights["b4"].reshape(1).float()
    w["dims"] = (c_end, c_rc, c_pos)
    return w


def cast_ief_operands(w: Dict[str, torch.Tensor],
                      dtype) -> Dict[str, torch.Tensor]:
    """The f32 split operands as K4 takes them: matrices in ``dtype``,
    biases 2 and 3 rounded to ``dtype`` and held in f32."""
    out = dict(w)
    for k in ("w1", "w2", "w3", "w4"):
        out[k] = w[k].to(dtype).contiguous()
    for k in ("b2", "b3"):
        out[k] = _q(w[k], dtype)
    return out


def prep_ief_weights(weights: Dict[str, torch.Tensor], c_end: int, c_rc: int,
                     c_pos: int, c_dir: int, dtype) -> Dict[str, torch.Tensor]:
    """The kernel operands (:func:`split_ief_weights` at the kernel's
    widths, :func:`pad_ief_operands`, cast by :func:`cast_ief_operands`);
    the end rows go with them at ``pad_columns(end, w["dims"][0])``."""
    return cast_ief_operands(pad_ief_operands(split_ief_weights(
        weights, c_end, c_rc, c_pos, c_dir, dtype)), dtype)


def ief_decode_plain(end_rows, rc_rows, pos_rows, w, *, n_iter=2,
                     init_offset=0.001, use_sigmoid=False, dtype=None):
    """end (N, c_end), rc (N, c_rc), pos_e (N, c_pos) -> (N,) f32 offsets
    after the squash. ``dtype``: the compute dtype (default: that of
    ``w["w1"]``, which may then hold f32 values)."""
    dtype = dtype or w["w1"].dtype
    x = torch.cat([end_rows.to(dtype), rc_rows.to(dtype), pos_rows.to(dtype)], 1)
    e1 = _dot(x, w["w1"][:x.shape[1]], dtype) + w["b1"]
    return _squash(_ief_loop(e1, w, "", n_iter, init_offset, dtype),
                   use_sigmoid)


def pad_ief_operands(w):
    """K4's operands ``w`` (the f32 split of :func:`split_ief_weights`, or
    its cast) at the kernel's widths: the decoder padded to
    :func:`compiled_gf` with zero units, c_end to a multiple of
    :data:`VOX_MULTIPLE` with zero end rows of w1 (the end rows take as
    many zero columns: :func:`pad_columns`). ``w`` itself where nothing is
    padded."""
    c_end, c_rc, c_pos = w["dims"]
    g = w["w1"].shape[1] // 4
    G, ce = compiled_gf(g), _round_up(c_end, VOX_MULTIPLE)
    if (g, c_end) == (G, ce):
        return w
    kp = _round_up(ce + c_rc + c_pos, _PAD)
    out = dict(w, dims=(ce, c_rc, c_pos))
    out["w1"] = _pad_to(_insert_rows(w["w1"], c_end, ce - c_end, kp),
                        (kp, 4 * G))
    for k in ("b1", "a_vec", "c_vec"):
        out[k] = _pad_to(w[k], (4 * G,))
    out.update(_pad_tails(w, ("",), g, G))
    return _contiguous(out)


def _ief_decode_cuda(end_rows, rc_rows, pos_rows, w, n_iter, init_offset,
                     use_sigmoid):
    dtype = w["w1"].dtype
    n = end_rows.shape[0]
    c_end, c_rc, c_pos = w["dims"]
    _check_cuda("ief_decode", [end_rows, rc_rows, pos_rows,
                               *(w[k] for k in _K4_WEIGHTS)], dtype)
    g = decoder_gf("ief_decode", w["w1"].shape[1], w["w2"].shape,
                   w["w3"].shape)
    if end_rows.shape != (n, c_end) or rc_rows.shape != (n, c_rc) \
            or pos_rows.shape != (n, c_pos):
        raise ValueError("ief_decode: operand shapes do not match the weights")
    is_bf16 = dtype == torch.bfloat16
    if is_bf16 and c_end % 8:
        raise ValueError(f"ief_decode kernel takes c_end a multiple of 8 in "
                         f"bf16 (got {c_end}; pad_ief_operands pads it)")
    _check_plan("ief_decode", "K4", w["w1"].shape[0], 0, n_iter, is_bf16, n,
                g)
    end_rows, rc_rows, pos_rows = (_aligned(t.to(dtype).contiguous())
                                   for t in (end_rows, rc_rows, pos_rows))
    out = torch.empty((n,), dtype=torch.float32, device=end_rows.device)
    ptrs = cuda.ptr_array([end_rows, rc_rows, pos_rows,
                           *(w[k] for k in _K4_WEIGHTS), out])
    fn = cuda.bind("ief_decode", "idt_ief_decode", cuda.PTR, *[cuda.I64] * 9,
                   cuda.F32)
    cuda.check(fn(ptrs, n, c_end, c_rc, c_pos, w["w1"].shape[0], n_iter, g,
                  int(is_bf16), int(use_sigmoid), init_offset,
                  cuda.stream_ptr(end_rows.device)), "ief_decode")
    return out


_K4_WEIGHTS = ("w1", "b1", "a_vec", "c_vec", "w2", "b2", "w3", "b3", "w4", "b4")


def ief_decode(end_rows, rc_rows, pos_rows, w, *, n_iter=2,
               init_offset=0.001, use_sigmoid=False):
    """Stage-2 IEF decode (see :func:`ief_decode_plain`); kernel K4 on CUDA.
    No gradient: raises when grad is enabled and an operand requires one
    (:func:`ief_decode_train` is the differentiable decode)."""
    if torch.is_grad_enabled() and any(
            torch.is_tensor(t) and t.requires_grad
            for t in (end_rows, rc_rows, pos_rows, *w.values())):
        raise RuntimeError("ief_decode carries no gradient, and an operand "
                           "requires one: decode through the training entry "
                           "(ief_decode_train), or under torch.no_grad()")
    if end_rows.device.type == "cpu":
        return ief_decode_plain(end_rows, rc_rows, pos_rows, w, n_iter=n_iter,
                                init_offset=init_offset,
                                use_sigmoid=use_sigmoid)
    out = _ief_decode_cuda(end_rows, rc_rows, pos_rows, w, n_iter,
                           init_offset, use_sigmoid)
    ief_decode.launches += 1
    return out


ief_decode.launches = 0


def _ief_train_operands(w32, dtype):
    """The f32 split operands with biases 2 and 3 rounded to ``dtype`` as
    the kernel takes them (straight through under autograd)."""
    return {**w32, "b2": _q(w32["b2"], dtype), "b3": _q(w32["b3"], dtype)}


class IefDecodeTrain(torch.autograd.Function):
    """The training IEF decode on the card: forward K4, backward autograd
    through :func:`ief_decode_plain` recomputed from the same inputs and the
    f32 split operands, as the JAX package's ``fused_ief_rows`` VJP
    recomputes through ``xla_ief_rows`` (no backward kernel there either).

    Takes the f32 split operands (:func:`split_ief_weights`) and casts them
    inside, so that their gradients reach the f32 parameters unrounded.
    Returns d end, d pos and every operand's gradient; d rc only when rc
    asks for one."""

    @staticmethod
    def forward(ctx, opts, end_rows, rc_rows, pos_rows, *ops):
        dtype, dims, n_iter, init_offset, use_sigmoid = opts
        w32 = dict(zip(_K4_WEIGHTS, ops), dims=dims)
        out = ief_decode(end_rows, rc_rows, pos_rows,
                         cast_ief_operands(w32, dtype), n_iter=n_iter,
                         init_offset=init_offset, use_sigmoid=use_sigmoid)
        ctx.opts = opts
        ctx.save_for_backward(end_rows, rc_rows, pos_rows, *ops)
        return out

    @staticmethod
    def backward(ctx, g):
        dtype, dims, n_iter, init_offset, use_sigmoid = ctx.opts
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[1:]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(n) for t, n in zip(saved, need)]
            end_rows, rc_rows, pos_rows, *ops = leaves
            w = _ief_train_operands(dict(zip(_K4_WEIGHTS, ops), dims=dims),
                                    dtype)
            out = ief_decode_plain(end_rows, rc_rows, pos_rows, w,
                                   n_iter=n_iter, init_offset=init_offset,
                                   use_sigmoid=use_sigmoid, dtype=dtype)
            wanted = [t for t, n in zip(leaves, need) if n]
            grads = iter(torch.autograd.grad(out, wanted, g)) if wanted else ()
        return (None, *(next(grads) if n else None for n in need))


def ief_decode_train(end_rows, rc_rows, pos_rows, w32, dtype, *, n_iter=2,
                     init_offset=0.001, use_sigmoid=False):
    """Differentiable stage-2 IEF decode of the refine training step.

    ``w32``: the f32 split operands from live parameters
    (:func:`split_ief_weights`, never the serving cache). CPU tensors take
    plain autograd through :func:`ief_decode_plain`; CUDA tensors take
    :class:`IefDecodeTrain` (K4 forward, the plain recompute backward) at
    the kernel's widths: the operands and the end rows are padded here,
    under autograd, which drops the pads' gradients."""
    kw = dict(n_iter=n_iter, init_offset=init_offset, use_sigmoid=use_sigmoid)
    if end_rows.device.type == "cpu":
        return ief_decode_plain(end_rows, rc_rows, pos_rows,
                                _ief_train_operands(w32, dtype), dtype=dtype,
                                **kw)
    w32 = pad_ief_operands(w32)
    end_rows = pad_columns(end_rows, w32["dims"][0])
    return IefDecodeTrain.apply(
        (dtype, w32["dims"], n_iter, init_offset, use_sigmoid),
        end_rows, rc_rows, pos_rows, *(w32[k] for k in _K4_WEIGHTS))
