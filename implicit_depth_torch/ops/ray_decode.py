"""Ray-major fused stage-1 decode: forward (kernels K1, K2) and backward (K3).

Counterpart of ``implicit_depth_tpu/ops/pallas_ray_decode.py``'s
``fused_ray_decode``, ``xla_ray_decode`` and ``_decode_rows``:
:func:`ray_decode` is the per-pair decode. The per_ray pair slots are
t-sorted and front-packed, so decoding the first ``kb`` slots of every ray
is a dense (N, kb) computation. Layer 1 of both decoders (IEF offset, IMNet
termination probability) is split into a per-PAIR part over [vox | pos6 |
trig] and a per-RAY part over [roi | dir_e], computed once per ray
(``split_l1``; :func:`ray_layout`). The positional encoding of the
enter/leave points is never materialised: only its sin/cos columns
(``trig``) are built from the raw positions, in the kernel. The kernel
reads each pair's voxel row by its cell id from the (B·G³, Cv) voxel table
instead of taking gathered (N·kb, Cv) rows. The kernels take every budget
1 <= kb <= ``MAX_KB`` (``rays_per_tile``), as the Pallas kernels take any
kb. The IEF decoder hoists layer 1 out of the iterations and folds the 1 ->
16 offset encoder into a rank-1 update; biases 1 and 4 add in f32, biases 2
and 3 are rounded to the compute dtype first (``ops/decode_common.py``).

The training decode (:func:`ray_decode_train`, :class:`RayDecodeTrain`)
runs K2 or K1 forward and K3 backward, by ``decode_bwd``.

Each wrapper runs the plain PyTorch version for CPU tensors and launches its
CUDA kernel (``csrc/ray_decode.cu``, ``csrc/ray_decode_bwd.cu``) for CUDA
tensors, counting launches in ``<wrapper>.launches``. The ``global`` and
dense stage-1 modes decode through ``ops/pair_decode.py`` (K6), stage 2
through ``ops/ief_decode.py`` (K4). The operands are padded to the kernels'
widths once, where they are made (``ops/decode_common.py::pad_operands``):
the serving operands (:func:`prep_ray_decode_weights`) and, on the card,
the training entry (:func:`ray_decode_train`). :func:`bwd_plan` and
:func:`bwd_smem` mirror K3's chunks, streams and Pass A on the host.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict

import torch

from implicit_depth_torch.ops import cuda
from implicit_depth_torch.ops.decode_common import (
    DECODER_GF,
    K_GRANULE,
    LEAKY,
    MAX_CRP,
    MAX_CVOX,
    MAX_KB,
    MAX_KP,
    MAX_SMEM,
    OperandFormat,
    act,
    aligned,
    cast_operands,
    check_cuda,
    check_plan,
    dot,
    operands_gf,
    pad_columns,
    pad_operands,
    pad_to,
    posenc_dim,
    rays_per_tile,
    round_biases,
    round_up,
    rounded,
    rows_operand,
    split_operands,
    squash,
)


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

def ray_layout(c_vox: int, c_ray: int, multires: int) -> dict:
    """K1/K2/K3's layer-1 layout: per pair [vox (c_vox) | pos6 | trig
    (12·multires) | 0 to kp], per ray [roi | dir_e (c_ray) | 0 to crp]; kp
    and crp are multiples of the 16-deep mma step."""
    return {"kp": round_up(c_vox + 2 * posenc_dim(multires), K_GRANULE),
            "crp": round_up(c_ray, K_GRANULE)}


FORMAT = OperandFormat(
    operands=("pair_w1", "ray_w1", "b1", "a_vec", "c_vec",
              "off_w2", "off_b2", "off_w3", "off_b3", "off_w4", "off_b4",
              "prob_w2", "prob_b2", "prob_w3", "prob_b3", "prob_w4",
              "prob_b4"),
    layer1=("pair_w1", "ray_w1"), prefixes=("off_", "prob_"),
    rounded=("off_b2", "off_b3", "prob_b2", "prob_b3"), layout=ray_layout)


def prep_ray_decode_weights(weights: Dict[str, torch.Tensor], c_vox: int,
                            c_roi: int, c_dir: int, multires: int,
                            dtype) -> Dict[str, torch.Tensor]:
    """The serving operands: :func:`split_ray_decode_weights` at the
    kernels' widths (``pad_operands``), cast as the kernels take them
    (``cast_operands``)."""
    return cast_operands(pad_operands(split_ray_decode_weights(
        weights, c_vox, c_roi, c_dir, multires, dtype), FORMAT), FORMAT,
        dtype)


def split_ray_decode_weights(weights: Dict[str, torch.Tensor], c_vox: int,
                             c_roi: int, c_dir: int, multires: int,
                             dtype) -> Dict[str, torch.Tensor]:
    """The decoder weights (``off_`` and ``prob_`` decoders) as the kernel
    operands (``split_operands``), all in f32. Layer 1's input layout is
    the embed [vox | roi | pe(enter) | pe(leave) | dir]; pair_w1 (kp, 2·4g)
    takes its rows [vox | pos6 | trig | 0-pad] and ray_w1 (crp, 2·4g) its
    rows [roi | dir | 0-pad] (:func:`ray_layout`), columns [off | prob]."""
    c_pos = 2 * posenc_dim(multires)
    half = c_pos // 2
    o1, o2, o3 = c_vox, c_vox + c_roi, c_vox + c_roi + c_pos
    lay = ray_layout(c_vox, c_roi + c_dir, multires)

    def rows(w1):
        pe = w1[o2:o3]
        pair = torch.cat([w1[:o1], pe[0:3], pe[half:half + 3],
                          pe[3:half], pe[half + 3:]], 0)
        ray = torch.cat([w1[o1:o2], w1[o3:]], 0)
        return (pad_to(pair, (lay["kp"], pair.shape[1])),
                pad_to(ray, (lay["crp"], ray.shape[1])))

    return split_operands(weights, FORMAT, o3 + c_dir,
                          (c_vox, c_roi + c_dir, multires), rows, dtype)


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
    trig = rounded(trig_block(pos6, multires), dtype)
    rows = vox_table[cells.reshape(-1).long()]
    # (float64: the table's gradient summed in float64 too)
    rows = rows.double() if dtype == torch.float64 else rows.float()
    x = torch.cat([rounded(rows, dtype), rounded(pos6, dtype), trig], 1)
    e1 = (dot(x, w["pair_w1"][:x.shape[1]], dtype)
          + dot(ray_feat, w["ray_w1"][:c_ray], dtype).repeat_interleave(kb, 0)
          + w["b1"])
    e1_off, z1p = keep(e1[:, :g4], "e1"), keep(e1[:, g4:], "z1p")
    acts = []

    def act_of(z, name):
        return _saved_act(z, sv[name]) if name in sv else act(z)

    def tail(h1, p, tag):
        """Layers 2-4 of decoder ``p`` (as ``mlp_tail``), h2 and h3
        from the saves named by ``tag`` where given."""
        h2 = act_of(dot(h1, w[f"{p}w2"], dtype) + w[f"{p}b2"], f"h2{tag}")
        h3 = act_of(dot(h2, w[f"{p}w3"], dtype) + w[f"{p}b3"], f"h3{tag}")
        acts.extend((h2, h3))
        return dot(h3, w[f"{p}w4"][:, None], dtype)[:, 0]

    offset = torch.full(e1_off.shape[:1], init_offset, dtype=torch.float32,
                        device=e1_off.device)
    offs = []
    for i in range(n_iter):
        offset = keep(offset, f"off{i}")
        offs.append(offset)
        h1 = act(e1_off + offset[:, None] * w["a_vec"] + w["c_vec"])
        offset = offset + tail(h1, "off_", f"_{i}") + w["off_b4"]
    offset = keep(offset, "off_fin")
    logit = keep(tail(act(z1p), "prob_", "p") + w["prob_b4"], "logit")
    out = (squash(offset, use_sigmoid).reshape(n, kb),
           squash(logit, use_sigmoid).reshape(n, kb))
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


def check_operands(name, vox_table, cells, pos, ray_feat, w):
    """Checks the K1/K2/K3 operands; returns them contiguous in the kernels'
    types."""
    dtype = w["pair_w1"].dtype
    n, kb = cells.shape
    c_vox, c_ray, multires = w["dims"]
    check_cuda(name, [vox_table, cells, pos, ray_feat,
                      *(w[k] for k in FORMAT.operands)], dtype)
    if not 1 <= kb <= MAX_KB:
        raise ValueError(f"{name} kernel takes 1 <= kb <= {MAX_KB} pair slots "
                         f"a ray (got kb={kb})")
    operands_gf(name, w, FORMAT)
    if vox_table.shape[1] != c_vox or ray_feat.shape != (n, c_ray) \
            or pos.shape != (n, kb, 6):
        raise ValueError(f"{name}: operand shapes do not match the weights")
    return (aligned(vox_table.to(dtype).contiguous()),
            cells.to(torch.int32).contiguous(), pos.float().contiguous(),
            aligned(ray_feat.to(dtype).contiguous()))


def _ray_decode_cuda(vox_table, cells, pos, ray_feat, w, n_iter, init_offset,
                     use_sigmoid, saves=False):
    """K1; with ``saves`` True K2 (K1 that also writes e1, z1p and trig),
    with ``saves`` 'all' K2 'all' (also every IEF iteration's offset, h2,
    h3, the probability decoder's, and the pre-squash outputs)."""
    name = {False: "ray_decode", True: "ray_decode_save",
            "all": "ray_decode_save_all"}[saves]
    vox_table, cells, pos, ray_feat = check_operands(
        name, vox_table, cells, pos, ray_feat, w)
    dtype = w["pair_w1"].dtype
    n, kb = cells.shape
    c_vox, c_ray, multires = w["dims"]
    kp, crp = w["pair_w1"].shape[0], w["ray_w1"].shape[0]
    g = w["b1"].shape[0] // 8
    is_bf16 = dtype == torch.bfloat16
    if is_bf16 and c_vox % 8:
        raise ValueError(f"{name} kernel takes c_vox a multiple of 8 in "
                         f"bf16 (got {c_vox}; pad_operands pads it)")
    check_plan(name, "K2all" if saves == "all" else "K1", kp, crp, n_iter,
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
                           *(w[k] for k in FORMAT.operands), *outs])
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


def ray_decode(vox_table, cells, pos, ray_feat, w, *, n_iter=2,
               init_offset=0.001, use_sigmoid=False):
    """Stage-1 decode (see :func:`ray_decode_plain`); kernel K1 on CUDA.
    ``vox_table``: the unpadded table in any float dtype, cast and padded
    here to the operands' (``rows_operand``) for either branch."""
    vox_table = rows_operand(vox_table, w, FORMAT)
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
                  for k in FORMAT.operands}
        vt = vox_table.detach().to(ft).requires_grad_()
        rf = ray_feat.detach().to(ft).requires_grad_()
        wq = round_biases({**w, **leaves}, FORMAT, dtype)
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
    for k in FORMAT.operands:
        out[k] = (off, shapes[k])
        off = round_up(off + math.prod(shapes[k]), 64)
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
        s_off = round_up(s_off + math.prod(layout[k][1]), 4)
    m = bwd_rows(kp, crp, c_vox, n_iter, s_off, g, is_bf16)
    mr = rays_per_tile(kb, m, max(4, m // 8))
    tpr = -(-kb // m)
    # the rays of kb 8's chunk at this batch (its tiles: m // 8 rays)
    chunk8 = round_up(-(-n // -(-n // chunk_rays)), m // 8)
    limit = max(mr, min(chunk_rays, chunk8 * 8 // kb) // mr * mr)
    n_chunks = -(-n // limit)
    chunk = round_up(-(-n // n_chunks), mr)
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
        off = round_up(off + r * widths[name] * inst, 64)
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
    table_off = round_up(p_off + blocks_a * s_off, 64)
    table_stride = round_up(table_elems, 64)
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
    a = lambda b: round_up(b, 128)  # noqa: E731
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

    ``w`` are the kernel operands (``cast_operands``);
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
    vox_table, cells, pos, ray_feat = check_operands(
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
                               *(w[k] for k in FORMAT.operands), *saves[:3], g,
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
        w32 = dict(zip(FORMAT.operands, ops), dims=dims)
        w = cast_operands(w32, FORMAT, dtype)
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
                              *(w[k] for k in FORMAT.operands), *saved)
        return off, logit

    @staticmethod
    def backward(ctx, g_off, g_logit):
        dtype, dims, n_iter, init_offset, use_sigmoid, decode_bwd = ctx.opts
        vox_table, cells, pos, ray_feat, *rest = ctx.saved_tensors
        w = dict(zip(FORMAT.operands, rest), dims=dims)
        saved = tuple(rest[len(FORMAT.operands):]) or None
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
                d_rf.to(ctx.in_dtypes[1]), *(d_w[k] for k in FORMAT.operands))


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
        return ray_decode_plain(vox_table, cells, pos, ray_feat,
                                round_biases(w32, FORMAT, dtype),
                                n_iter=n_iter, init_offset=init_offset,
                                use_sigmoid=use_sigmoid, dtype=dtype)
    w32 = pad_operands(w32, FORMAT)
    vox_table = pad_columns(vox_table, w32["dims"][0])
    return RayDecodeTrain.apply(
        (dtype, w32["dims"], n_iter, init_offset, use_sigmoid, decode_bwd),
        vox_table, cells, pos, ray_feat, *(w32[k] for k in FORMAT.operands))
