"""Stage-2 per-ray IEF decode (kernel K4, ``csrc/ief_decode.cu``).

Counterpart of ``implicit_depth_tpu/ops/pallas_ray_decode.py``'s
``fused_ief_rows``, ``xla_ief_rows`` and ``_ief_rows``: :func:`ief_decode`
decodes each row's offset from its embed parts [end | rc | pos_e] by the
IEF decoder, its layer 1 hoisted out of the iterations and the 1 -> 16
offset encoder folded into a rank-1 update (``ops/decode_common.py``). It is
forward only and refuses an operand that asks for a gradient.
:func:`ief_decode_train` is the refine training's decode: K4 forward and,
as ``fused_ief_rows``' VJP recomputes through ``xla_ief_rows``, autograd
of the plain decode recomputed (:class:`IefDecodeTrain`).

:func:`ief_decode` runs :func:`ief_decode_plain` for CPU tensors and
launches K4 for CUDA tensors, counting launches in ``ief_decode.launches``.
The operands are padded to the kernel's widths once, where they are made
(``ops/decode_common.py::pad_operands``; c_end is padded as the voxel
width): the serving operands (:func:`prep_ief_weights`) and, on the card,
the training entry (:func:`ief_decode_train`).
"""

from __future__ import annotations

from typing import Dict

import torch

from implicit_depth_torch.ops import cuda
from implicit_depth_torch.ops.decode_common import (
    K_GRANULE,
    OperandFormat,
    aligned,
    cast_operands,
    check_cuda,
    check_plan,
    dot,
    ief_loop,
    operands_gf,
    pad_columns,
    pad_operands,
    pad_to,
    round_biases,
    round_up,
    rows_operand,
    split_operands,
    squash,
)


def ief_layout(c_end: int, c_rc: int, c_pos: int) -> dict:
    """K4's layer-1 layout, the columns of a row's X (and w1's rows): [end
    (c_end) | rc = (roi, dir) (c_rc) | pos_e (c_pos) | 0 to kp], kp a
    multiple of the 16-deep mma step."""
    return {"kp": round_up(c_end + c_rc + c_pos, K_GRANULE)}


FORMAT = OperandFormat(
    operands=("w1", "b1", "a_vec", "c_vec", "w2", "b2", "w3", "b3", "w4",
              "b4"),
    layer1=("w1",), prefixes=("",), rounded=("b2", "b3"), layout=ief_layout)


def split_ief_weights(weights: Dict[str, torch.Tensor], c_end: int,
                      c_rc: int, c_pos: int, c_dir: int,
                      dtype) -> Dict[str, torch.Tensor]:
    """The refine IEF weights (JAX layout enc_w/enc_b, w1..w4, b1..b4) over
    the stage-2 embed [end | roi | pos_e | dir_e | enc(16)] as the kernel
    operands (``split_operands``), all in f32: w1 (kp, 4g) takes its rows
    [end | rc = (roi, dir) | pos | 0-pad] (:func:`ief_layout`)."""
    o2 = c_end + c_rc - c_dir
    o3 = o2 + c_pos
    kp = ief_layout(c_end, c_rc, c_pos)["kp"]

    def rows(w1):
        w = torch.cat([w1[:o2], w1[o3:], w1[o2:o3]], 0)
        return (pad_to(w, (kp, w.shape[1])),)

    return split_operands(weights, FORMAT, o3 + c_dir, (c_end, c_rc, c_pos),
                          rows, dtype)


def prep_ief_weights(weights: Dict[str, torch.Tensor], c_end: int, c_rc: int,
                     c_pos: int, c_dir: int, dtype) -> Dict[str, torch.Tensor]:
    """The serving operands: :func:`split_ief_weights` at the kernel's
    widths (``pad_operands``), cast as the kernel takes them
    (``cast_operands``)."""
    return cast_operands(pad_operands(split_ief_weights(
        weights, c_end, c_rc, c_pos, c_dir, dtype), FORMAT), FORMAT, dtype)


def ief_decode_plain(end_rows, rc_rows, pos_rows, w, *, n_iter=2,
                     init_offset=0.001, use_sigmoid=False, dtype=None):
    """end (N, c_end), rc (N, c_rc), pos_e (N, c_pos) -> (N,) f32 offsets
    after the squash. ``dtype``: the compute dtype (default: that of
    ``w["w1"]``, which may then hold f32 values)."""
    dtype = dtype or w["w1"].dtype
    x = torch.cat([end_rows.to(dtype), rc_rows.to(dtype), pos_rows.to(dtype)], 1)
    e1 = dot(x, w["w1"][:x.shape[1]], dtype) + w["b1"]
    return squash(ief_loop(e1, w, "", n_iter, init_offset, dtype),
                  use_sigmoid)


def _ief_decode_cuda(end_rows, rc_rows, pos_rows, w, n_iter, init_offset,
                     use_sigmoid):
    dtype = w["w1"].dtype
    n = end_rows.shape[0]
    c_end, c_rc, c_pos = w["dims"]
    check_cuda("ief_decode", [end_rows, rc_rows, pos_rows,
                              *(w[k] for k in FORMAT.operands)], dtype)
    g = operands_gf("ief_decode", w, FORMAT)
    if end_rows.shape != (n, c_end) or rc_rows.shape != (n, c_rc) \
            or pos_rows.shape != (n, c_pos):
        raise ValueError("ief_decode: operand shapes do not match the weights")
    is_bf16 = dtype == torch.bfloat16
    if is_bf16 and c_end % 8:
        raise ValueError(f"ief_decode kernel takes c_end a multiple of 8 in "
                         f"bf16 (got {c_end}; pad_operands pads it)")
    check_plan("ief_decode", "K4", w["w1"].shape[0], 0, n_iter, is_bf16, n,
               g)
    end_rows, rc_rows, pos_rows = (aligned(t.to(dtype).contiguous())
                                   for t in (end_rows, rc_rows, pos_rows))
    out = torch.empty((n,), dtype=torch.float32, device=end_rows.device)
    ptrs = cuda.ptr_array([end_rows, rc_rows, pos_rows,
                           *(w[k] for k in FORMAT.operands), out])
    fn = cuda.bind("ief_decode", "idt_ief_decode", cuda.PTR, *[cuda.I64] * 9,
                   cuda.F32)
    cuda.check(fn(ptrs, n, c_end, c_rc, c_pos, w["w1"].shape[0], n_iter, g,
                  int(is_bf16), int(use_sigmoid), init_offset,
                  cuda.stream_ptr(end_rows.device)), "ief_decode")
    return out


def ief_decode(end_rows, rc_rows, pos_rows, w, *, n_iter=2,
               init_offset=0.001, use_sigmoid=False):
    """Stage-2 IEF decode (see :func:`ief_decode_plain`); kernel K4 on CUDA.
    ``end_rows``: unpadded, in any float dtype, cast and padded here to the
    operands' (``rows_operand``) for either branch. No gradient: raises
    when grad is enabled and an operand requires one
    (:func:`ief_decode_train` is the differentiable decode)."""
    if torch.is_grad_enabled() and any(
            torch.is_tensor(t) and t.requires_grad
            for t in (end_rows, rc_rows, pos_rows, *w.values())):
        raise RuntimeError("ief_decode carries no gradient, and an operand "
                           "requires one: decode through the training entry "
                           "(ief_decode_train), or under torch.no_grad()")
    end_rows = rows_operand(end_rows, w, FORMAT)
    if end_rows.device.type == "cpu":
        return ief_decode_plain(end_rows, rc_rows, pos_rows, w, n_iter=n_iter,
                                init_offset=init_offset,
                                use_sigmoid=use_sigmoid)
    out = _ief_decode_cuda(end_rows, rc_rows, pos_rows, w, n_iter,
                           init_offset, use_sigmoid)
    ief_decode.launches += 1
    return out


ief_decode.launches = 0


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
        w32 = dict(zip(FORMAT.operands, ops), dims=dims)
        out = ief_decode(end_rows, rc_rows, pos_rows,
                         cast_operands(w32, FORMAT, dtype), n_iter=n_iter,
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
            w = round_biases(dict(zip(FORMAT.operands, ops), dims=dims),
                             FORMAT, dtype)
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
                                round_biases(w32, FORMAT, dtype), dtype=dtype,
                                **kw)
    w32 = pad_operands(w32, FORMAT)
    end_rows = pad_columns(end_rows, w32["dims"][0])
    return IefDecodeTrain.apply(
        (dtype, w32["dims"], n_iter, init_offset, use_sigmoid),
        end_rows, rc_rows, pos_rows, *(w32[k] for k in FORMAT.operands))
