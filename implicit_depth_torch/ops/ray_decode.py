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
  (N·kb, Cv) rows.
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
through ``ops/pair_decode.py`` (K6). :func:`decode_plan` mirrors the
forward kernels' tiles, shared memory and weight schedule on the host
(``csrc/decode_tile.cuh``); the wrappers refuse widths it says do not fit.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict

import torch

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
    that weight gradients stay f32 as the JAX kernel accumulates them."""
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
    """The kernel operands (:func:`split_ray_decode_weights` cast by
    :func:`cast_ray_decode_operands`)."""
    return cast_ray_decode_operands(split_ray_decode_weights(
        weights, c_vox, c_roi, c_dir, multires, dtype), dtype)


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
    x = torch.cat([_q(vox_table[cells.reshape(-1).long()].float(), dtype),
                   _q(pos6, dtype), trig], 1)
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
F32_ROWS = 32          # rows of an f32 block (FMA path)
# the widest layer-1 inputs the wrappers accept: per pair or row (kp), per
# ray (crp; K1); K1's kp is K3's limit too; K6's fills the shared memory
MAX_KP = {"K1": 256, "K2all": 256, "K4": 384, "K6": 464}
MAX_CRP = 256
_SEG_BYTES = 24        # sizeof(Seg)


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


def decode_plan(kernel: str, kp: int, crp: int = 0, n_iter: int = 2,
                is_bf16: bool = True, n: int = 0, sm_count: int = 132) -> dict:
    """The host-side arithmetic of the forward decodes, as the kernels lay
    it out: ``kernel`` "K1" (also K2; ``n`` rays of kb = 8 pairs, layer-1
    widths ``kp`` per pair and ``crp`` per ray), "K2all" (K2 'all': K1's
    layout, its saves go from registers and the shared h2 tile to device
    memory), "K4" (``n`` rows, layer-1 width ``kp``) or "K6" (``n`` pair
    rows, layer-1 width ``kp``: ``ops/pair_decode.py::pair_layout``; the
    operand "w1" holds both decoders' layer 1, offset columns first).

    bf16 (``csrc/decode_tile.cuh``): a persistent grid of ``blocks`` = one
    block per SM (at most the number of tiles) walks ``tiles`` tiles of
    TILE_ROWS rows (8 rays for K1); ``smem`` holds the byte offset of each
    region of ``tile::Smem`` and ``"total"``; ``schedule`` lists each
    product of a tile in the order its weights stream through the slab
    ring: (operand, first column, k, n, slab rows), and ``slabs_per_tile``
    their number. f32: one block per tile of F32_ROWS rows, the FMA
    kernels' ``Smem`` (no schedule)."""
    if kernel not in ("K1", "K2all", "K4", "K6"):
        raise ValueError(f"decode_plan: kernel {kernel!r}")
    k1 = kernel in ("K1", "K2all")
    g1, g2, g3 = _G1, _G2, _G3
    if is_bf16:
        ld = lambda w: w + TILE_PAD  # noqa: E731
        xb = TILE_ROWS * ld(kp) * 2
        smem = _regions([
            ("x0", xb), ("x1", xb),
            ("rf", 16 * ld(crp) * 2 if k1 else 0),
            ("ray", 8 * 2 * g1 * 4 if k1 else 0),
            ("h", TILE_ROWS * ld(g1) * 2), ("h2", TILE_ROWS * ld(g2) * 2),
            ("ring", RING * SLAB_ELEMS * 2), ("off", TILE_ROWS * 4),
            ("logit", TILE_ROWS * 4), ("l4", WARPS_N * TILE_ROWS * 4),
            ("segs", MAX_SEGS * _SEG_BYTES)])
        tail = [("w2", 0, g1, g2), ("w3", 0, g2, g3)]
        if k1:
            sched = [("ray_w1", 0, crp, 2 * g1), ("pair_w1", g1, kp, g1),
                     *((f"prob_{w}", c, k, nn) for w, c, k, nn in tail),
                     ("pair_w1", 0, kp, g1),
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
        tiles = -(-n // (rows // 8 if k1 else rows))
        return {"rows_per_tile": rows, "tiles": tiles,
                "blocks": min(tiles, sm_count), "smem": smem,
                "schedule": sched,
                "slabs_per_tile": sum(-(-k // s) for _, _, k, _, s in sched)}
    m = F32_ROWS
    x = m * max(kp, g2 + g3) * 4
    if k1:
        smem = _regions([("x", x), ("e1", m * g1 * 4), ("c", m * g1 * 4),
                         ("h", m * g1 * 4), ("ray", (m // 8) * 2 * g1 * 4),
                         ("off", m * 4), ("logit", m * 4)])
    elif kernel == "K6":
        smem = _regions([("x", x), ("e1", m * g1 * 4), ("c", m * g1 * 4),
                         ("h", m * g1 * 4), ("off", m * 4), ("logit", m * 4)])
    else:
        smem = _regions([("x", x), ("e1", m * g1 * 4), ("c", m * g2 * 4),
                         ("h", m * g1 * 4), ("off", m * 4)])
    tiles = -(-n // (m // 8 if k1 else m))
    return {"rows_per_tile": m, "tiles": tiles, "blocks": tiles,
            "smem": smem, "schedule": [], "slabs_per_tile": 0}


def _check_plan(name, kernel, kp, crp, n_iter, is_bf16, n):
    """Raises unless the kernel takes these widths; returns the plan."""
    plan = decode_plan(kernel, kp, crp, n_iter, is_bf16, n)
    if kp > MAX_KP[kernel] or crp > MAX_CRP \
            or plan["smem"]["total"] > MAX_SMEM \
            or len(plan["schedule"]) > MAX_SEGS:
        raise ValueError(f"{name}: widths kp={kp}, crp={crp} or n_iter="
                         f"{n_iter} do not fit the kernel (at most "
                         f"{MAX_KP[kernel]}, {MAX_CRP}; {MAX_SEGS} products a "
                         f"tile; {plan['smem']['total']} bytes of shared "
                         "memory)")
    return plan


def _decode_operands(name, vox_table, cells, pos, ray_feat, w):
    """Checks the K1/K2/K3 operands; returns them contiguous in the kernels'
    types."""
    dtype = w["pair_w1"].dtype
    n, kb = cells.shape
    c_vox, c_ray, multires = w["dims"]
    g4 = w["b1"].shape[0] // 2
    _check_cuda(name, [vox_table, cells, pos, ray_feat,
                       *(w[k] for k in _K1_WEIGHTS)], dtype)
    if kb != 8 or g4 != 256 or w["off_w3"].shape != (128, 64):
        raise ValueError(f"{name} kernel takes kb=8 and layer widths "
                         f"256-128-64-1 (got kb={kb}, 4g={g4})")
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
    is_bf16 = dtype == torch.bfloat16
    if is_bf16 and c_vox % 8:
        raise ValueError(f"{name} kernel takes c_vox a multiple of 8 in "
                         f"bf16 (got {c_vox})")
    _check_plan(name, "K2all" if saves == "all" else "K1", kp, crp, n_iter,
                is_bf16, n)
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
                 torch.empty((inst, rows, _G2), dtype=dtype, device=dev),
                 torch.empty((inst, rows, _G3), dtype=dtype, device=dev),
                 torch.empty((rows, 1), dtype=torch.float32, device=dev)]
    ptrs = cuda.ptr_array([vox_table, cells, pos, ray_feat,
                           *(w[k] for k in _K1_WEIGHTS), *outs])
    fn = cuda.bind("ray_decode", f"idt_{name}", cuda.PTR, *[cuda.I64] * 9,
                   cuda.F32)
    cuda.check(fn(ptrs, n, c_vox, c_ray, multires, kp, crp, n_iter,
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
    {operand: gradient}), all f32. With ``saved`` (K2's e1, z1p, trig, or
    K2 'all''s full saves, :func:`save_names`) the decode starts from the
    saved values, as K3 does (``from_saves`` of :func:`ray_decode_plain`)."""
    with torch.enable_grad():
        leaves = {k: w[k].detach().float().requires_grad_()
                  for k in _K1_WEIGHTS}
        vt = vox_table.detach().float().requires_grad_()
        rf = ray_feat.detach().float().requires_grad_()
        wq = {**w, **leaves}
        wq.update({k: _q(wq[k], dtype) for k in _ROUNDED_BIASES})
        off, logit = ray_decode_plain(
            vt, cells, pos, rf, wq, n_iter=n_iter, init_offset=init_offset,
            use_sigmoid=use_sigmoid, dtype=dtype, from_saves=saved)
        grads = torch.autograd.grad((off, logit), [vt, rf, *leaves.values()],
                                    (g_off.float(), g_logit.float()))
    return grads[0], grads[1], dict(zip(leaves, grads[2:]))


# -- K3's plan: chunks of rays, operand streams, the weight-gradient products

K3_CHUNK_RAYS = 32768  # rays per chunk of the operand streams, at most
K3_SPLIT_ROWS = 4096   # contraction rows of one Pass B block
K3_TILE = (64, 128)    # Pass B's output tile (gradient rows, columns)
_G1, _G2, _G3 = 256, 128, 64
# the operand streams Pass A writes, each (rows per instance, width): rows
# are a chunk's pair rows, or its rays for the per-ray streams
K3_STREAMS = ("x", "de_off", "de_prob", "rf", "dre_off", "dre_prob",
              "h1", "dt2", "h2", "dt3")
_PER_RAY_STREAMS = ("rf", "dre_off", "dre_prob")
_TAIL_STREAMS = ("h1", "dt2", "h2", "dt3")
# the gradients Pass A sums per block (f32, in shared memory), in order
K3_SMALL = ("b1", "a_vec", "c_vec", "off_b2", "off_b3", "off_w4", "off_b4",
            "prob_b2", "prob_b3", "prob_w4", "prob_b4")
# Pass B's products: (gradient, column offset in it, A stream, B stream,
# IEF instances (else the probability decoder's, instance 0))
K3_JOBS = (("pair_w1", 0, "x", "de_off", False),
           ("pair_w1", _G1, "x", "de_prob", False),
           ("ray_w1", 0, "rf", "dre_off", False),
           ("ray_w1", _G1, "rf", "dre_prob", False),
           ("off_w2", 0, "h1", "dt2", True),
           ("prob_w2", 0, "h1", "dt2", False),
           ("off_w3", 0, "h2", "dt3", True),
           ("prob_w3", 0, "h2", "dt3", False))
_PLAN_HEADER = 40   # int64 fields before the jobs (see csrc/ray_decode_bwd.cu)
_JOB_FIELDS, _RED_FIELDS = 12, 9


def _align(x: int, a: int = 64) -> int:
    return -(-x // a) * a


def bwd_grad_layout(kp: int, crp: int) -> Dict[str, tuple]:
    """{operand: (float offset, shape)} of each weight gradient in K3's f32
    output, in the operand order of K1/K2, each at a 64-float boundary;
    ``"total"``: (its size, ())."""
    shapes = {"pair_w1": (kp, 2 * _G1), "ray_w1": (crp, 2 * _G1),
              "b1": (2 * _G1,), "a_vec": (_G1,), "c_vec": (_G1,)}
    for p in ("off", "prob"):
        shapes.update({f"{p}_w2": (_G1, _G2), f"{p}_b2": (_G2,),
                       f"{p}_w3": (_G2, _G3), f"{p}_b3": (_G3,),
                       f"{p}_w4": (_G3,), f"{p}_b4": (1,)})
    out, off = {}, 0
    for k in _K1_WEIGHTS:
        out[k] = (off, shapes[k])
        off = _align(off + math.prod(shapes[k]))
    out["total"] = (off, ())
    return out


def bwd_plan(n: int, kp: int, crp: int, n_iter: int, is_bf16: bool,
             sm_count: int, chunk_rays: int = K3_CHUNK_RAYS,
             split_rows: int = K3_SPLIT_ROWS, table_elems: int = 0) -> dict:
    """The host-side arithmetic of K3 for ``n`` rays of kb = 8 pairs and a
    voxel table of ``table_elems`` elements (rows x c_vox).

    Pass A walks the rays in ``n_chunks`` chunks of at most
    ``chunk_rays`` rays (equal but for the last), tiles of ``rows_per_tile``
    pair rows (64 bf16, 32 f32) on a persistent grid of ``blocks_a`` blocks,
    and writes each weight gradient's operands into the streams
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
    m = 64 if is_bf16 else 32
    mr = m // 8
    n_chunks = -(-n // chunk_rays)
    chunk = _align(-(-n // n_chunks), mr)
    n_chunks = -(-n // chunk)
    n_inst = n_iter + 1
    rows = chunk * 8
    widths = {"x": kp, "de_off": _G1, "de_prob": _G1, "rf": crp,
              "dre_off": _G1, "dre_prob": _G1, "h1": _G1, "dt2": _G2,
              "h2": _G2, "dt3": _G3}
    streams, off = {}, 0
    for name in K3_STREAMS:
        r = chunk if name in _PER_RAY_STREAMS else rows
        inst = n_inst if name in _TAIL_STREAMS else 1
        streams[name] = (off, r, widths[name], inst)
        off = _align(off + r * widths[name] * inst)
    scratch = off
    layout = bwd_grad_layout(kp, crp)
    jobs, reds, p_off, blocks_b = [], [], 0, 0
    tk_rows, tn_cols = K3_TILE
    for grad, col, a, b, ief in K3_JOBS:
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
    tiles = -(-chunk // mr)
    blocks_a = max(1, min(sm_count, tiles))
    small, s_off = {}, 0
    for k in K3_SMALL:
        size = math.prod(layout[k][1])
        small[k] = s_off
        reds.append({"src": p_off + s_off, "stride": 0, "dst": layout[k][0],
                     "splits": blocks_a, "k": 1, "n": size, "ld_src": size,
                     "ld_dst": size})
        s_off = _align(s_off + size, 4)
    for r in reds[len(jobs):]:
        r["stride"] = s_off
    table_off = _align(p_off + blocks_a * s_off)
    table_stride = _align(table_elems)
    return {"rows_per_tile": m, "chunk_rays": chunk, "n_chunks": n_chunks,
            "tiles_per_chunk": tiles, "blocks_a": blocks_a,
            "n_inst": n_inst, "split_rows": split_rows, "streams": streams,
            "scratch_elems": scratch, "jobs": jobs, "blocks_b": blocks_b,
            "small": small, "small_size": s_off, "small_off": p_off,
            "table_off": table_off, "table_stride": table_stride,
            "table_elems": table_elems,
            "partial_floats": table_off + blocks_a * table_stride,
            "reds": reds, "grad_floats": layout["total"][0]}


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
            plan["table_stride"], plan["table_elems"]]
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
    ``ray_decode_bwd.launches``."""
    out = _ray_decode_bwd_cuda(vox_table, cells, pos, ray_feat, w, saved,
                               g_off, g_logit, n_iter=n_iter,
                               init_offset=init_offset,
                               use_sigmoid=use_sigmoid)
    ray_decode_bwd.launches += 1
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
    (n_iter + 1, N·kb, 1) f32, h2 (n_iter + 1, N·kb, g2), h3 and the logit
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
                 "trig": (12 * multires, dtype), "h2": (_G2, dtype),
                 "h3": (_G3, dtype)}.get(name[:2] if name[0] == "h" else name,
                                         (1, torch.float32))
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
                         use_sigmoid=False, events=None):
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
    run)."""
    vox_table, cells, pos, ray_feat = _decode_operands(
        "ray_decode_bwd", vox_table, cells, pos, ray_feat, w)
    dtype = w["pair_w1"].dtype
    n, kb = cells.shape
    c_vox, c_ray, multires = w["dims"]
    g4 = w["b1"].shape[0] // 2
    dev = cells.device
    saves = _bwd_saves(saved, n, kb, g4, multires, n_iter, dtype, dev)
    if c_vox % 32 or c_vox > 256 or w["pair_w1"].shape[0] > 256:
        raise ValueError(f"ray_decode_bwd kernel takes c_vox a multiple of "
                         f"32 up to 256 (got {c_vox})")
    g = torch.stack([g_off.float(), g_logit.float()], -1).contiguous()
    if g.shape != (n, kb, 2):
        raise ValueError("ray_decode_bwd: cotangents must be (N, kb)")
    kp, crp = w["pair_w1"].shape[0], w["ray_w1"].shape[0]
    layout = bwd_grad_layout(kp, crp)
    d_w = torch.empty((layout["total"][0],), dtype=torch.float32, device=dev)
    d_table = torch.empty(vox_table.shape, dtype=torch.float32, device=dev)
    d_rf = torch.empty((n, c_ray), dtype=torch.float32, device=dev)
    if n > 0:
        plan = bwd_plan(n, kp, crp, n_iter, dtype == torch.bfloat16,
                        cuda.sm_count(dev), K3_CHUNK_RAYS, K3_SPLIT_ROWS,
                        vox_table.numel())
        packed = pack_bwd_plan(plan)
        scratch = torch.empty((plan["scratch_elems"],), dtype=dtype,
                              device=dev)
        partials = torch.empty((plan["partial_floats"],),
                               dtype=torch.float32, device=dev)
        # the recompute instance keeps each block's f32 e1 tile in a slice
        # of its own
        e1_scratch = None if saved is not None else torch.empty(
            (plan["blocks_a"], plan["rows_per_tile"], g4),
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
        fn = cuda.bind("ray_decode_bwd", "idt_ray_decode_bwd", cuda.PTR,
                       cuda.PTR, *[cuda.I64] * 10, cuda.F32, cuda.PTR)
        cuda.check(fn(ptrs, (cuda.I64 * len(packed))(*packed), len(packed),
                      n, c_vox, c_ray, multires, kp, crp, n_iter,
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
    implements each of ``DECODE_BWD_MODES``."""
    if decode_bwd not in DECODE_BWD_MODES:
        raise ValueError(f"decode_bwd {decode_bwd!r}")
    if cells.device.type == "cpu":
        w = {**w32, **{k: _q(w32[k], dtype) for k in _ROUNDED_BIASES}}
        return ray_decode_plain(vox_table, cells, pos, ray_feat, w,
                                n_iter=n_iter, init_offset=init_offset,
                                use_sigmoid=use_sigmoid, dtype=dtype)
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
    """The kernel operands (:func:`split_ief_weights` cast by
    :func:`cast_ief_operands`)."""
    return cast_ief_operands(split_ief_weights(weights, c_end, c_rc, c_pos,
                                               c_dir, dtype), dtype)


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


def _ief_decode_cuda(end_rows, rc_rows, pos_rows, w, n_iter, init_offset,
                     use_sigmoid):
    dtype = w["w1"].dtype
    n = end_rows.shape[0]
    c_end, c_rc, c_pos = w["dims"]
    _check_cuda("ief_decode", [end_rows, rc_rows, pos_rows,
                               *(w[k] for k in _K4_WEIGHTS)], dtype)
    if w["w1"].shape[1] != 256 or w["w3"].shape != (128, 64):
        raise ValueError("ief_decode kernel takes layer widths 256-128-64-1")
    if end_rows.shape != (n, c_end) or rc_rows.shape != (n, c_rc) \
            or pos_rows.shape != (n, c_pos):
        raise ValueError("ief_decode: operand shapes do not match the weights")
    is_bf16 = dtype == torch.bfloat16
    if is_bf16 and c_end % 8:
        raise ValueError(f"ief_decode kernel takes c_end a multiple of 8 in "
                         f"bf16 (got {c_end})")
    _check_plan("ief_decode", "K4", w["w1"].shape[0], 0, n_iter, is_bf16, n)
    end_rows, rc_rows, pos_rows = (_aligned(t.to(dtype).contiguous())
                                   for t in (end_rows, rc_rows, pos_rows))
    out = torch.empty((n,), dtype=torch.float32, device=end_rows.device)
    ptrs = cuda.ptr_array([end_rows, rc_rows, pos_rows,
                           *(w[k] for k in _K4_WEIGHTS), out])
    fn = cuda.bind("ief_decode", "idt_ief_decode", cuda.PTR, *[cuda.I64] * 8,
                   cuda.F32)
    cuda.check(fn(ptrs, n, c_end, c_rc, c_pos, w["w1"].shape[0], n_iter,
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
    :class:`IefDecodeTrain` (K4 forward, the plain recompute backward)."""
    kw = dict(n_iter=n_iter, init_offset=init_offset, use_sigmoid=use_sigmoid)
    if end_rows.device.type == "cpu":
        return ief_decode_plain(end_rows, rc_rows, pos_rows,
                                _ief_train_operands(w32, dtype), dtype=dtype,
                                **kw)
    return IefDecodeTrain.apply(
        (dtype, w32["dims"], n_iter, init_offset, use_sigmoid),
        end_rows, rc_rows, pos_rows, *(w32[k] for k in _K4_WEIGHTS))
