"""The plain reference of the two-stage model, in float32 (or, for the
control, with every product's operands rounded to fp8): stage 1 (the
dilated ResNet34-8s, the two-stage PointNet over the voxel grid, the ROI
window pool and the IEF offset and IMNet probability decoders over each
ray's nearest ``kb`` pair slots), the RefineNet iterations, and both
stages' training losses.

Functions of a parameter dict keyed as the model under test keys its
state dict ("resnet.layer1_0.conv1.weight", "pnet.l0.weight",
"offset_dec.mlp.l0.weight", ...); no module of the program is imported.
Every width comes from the configuration dict that the benchmark's
configuration file gives.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from benchmark.reference import geometry

T = Dict[str, torch.Tensor]
LEAKY = 0.02
FP8_MAX = 448.0


class Precision:
    """The operands' rounding of every product: ``f32`` (none), ``bf16``
    or ``fp8`` (e4m3, each tensor scaled by its largest magnitude); the
    gradient passes the rounding unchanged."""

    def __init__(self, name: str = "f32"):
        if name not in ("f32", "bf16", "fp8"):
            raise ValueError(f"precision {name!r}")
        self.name = name

    def q(self, x):
        if self.name == "f32":
            return x
        if self.name == "bf16":
            return x + (x.detach().to(torch.bfloat16).float() - x).detach()
        s = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
        r = (x.detach() / s).to(torch.float8_e4m3fn).float() * s
        return x + (r - x).detach()


def dense(x, p: T, name: str, prec: Precision):
    return prec.q(x) @ prec.q(p[name + ".weight"]).t() + p[name + ".bias"]


def act(x):
    return F.leaky_relu(x, LEAKY)


def soft_clamp01(x):
    return torch.maximum(torch.minimum(x, 0.01 * x + 0.99), 0.01 * x)


def posenc(x, m):
    """x (..., 3) -> [x | sin, cos of x·2^j, j < m] (cos as sin(· + π/2))."""
    freqs = torch.tensor([2.0 ** j for j in range(m)], device=x.device)
    phase = torch.tensor([0.0, math.pi / 2], device=x.device)
    arg = x.float()[..., None, None, :] * freqs[:, None, None] + phase[:, None]
    return torch.cat([x, torch.sin(arg).reshape(*x.shape[:-1], -1)], -1)


def posenc_dim(m):
    return 3 * (1 + 2 * m)


# -- specification of the parameters -----------------------------------------

def _resnet_spec(out_ch: int):
    spec = [("resnet.conv1.weight", (64, 3, 7, 7))] + _bn("resnet.bn1", 64)
    inplanes, stride_now = 64, 4
    for stage, (blocks, planes) in enumerate(zip((3, 4, 6, 3),
                                                 (64, 128, 256, 512))):
        stride = 1 if stage == 0 else 2
        if stride != 1 and stride_now == 8:
            stride = 1
        else:
            stride_now *= stride
        for i in range(blocks):
            n = f"resnet.layer{stage + 1}_{i}"
            spec += [(n + ".conv1.weight", (planes, inplanes, 3, 3))]
            spec += _bn(n + ".bn1", planes)
            spec += [(n + ".conv2.weight", (planes, planes, 3, 3))]
            spec += _bn(n + ".bn2", planes)
            if i == 0 and (stride != 1 or inplanes != planes):
                spec += [(n + ".down_conv.weight", (planes, inplanes, 1, 1))]
                spec += _bn(n + ".down_bn", planes)
            inplanes = planes
    return spec + [("resnet.fc.weight", (out_ch, 512, 1, 1)),
                   ("resnet.fc.bias", (out_ch,))]


def _bn(n, c):
    return [(n + s, (c,)) for s in (".weight", ".bias", ".running_mean",
                                    ".running_var")] \
        + [(n + ".num_batches_tracked", ())]


def _lin(n, i, o):
    return [(n + ".weight", (o, i)), (n + ".bias", (o,))]


def _pnet_spec(pre, out, gf):
    h = out // 2
    return (_lin(pre + "l0", 6, gf) + _lin(pre + "l1", gf, h)
            + _lin(pre + "v1_mlp", h, h) + _lin(pre + "l3", out, out)
            + _lin(pre + "l4", out, out) + _lin(pre + "v2_mlp", out, out))


def _mlp_spec(pre, i, g):
    return (_lin(pre + "l0", i, 4 * g) + _lin(pre + "l1", 4 * g, 2 * g)
            + _lin(pre + "l2", 2 * g, g) + _lin(pre + "l3", g, 1))


def lidf_embed_dim(m: dict) -> int:
    return (m["pnet_out"] + m["rgb_out"] * m["roi_out_bbox"] ** 2
            + 2 * posenc_dim(m["multires"]) + posenc_dim(m["multires_views"]))


def refine_embed_dim(m: dict, r: dict) -> int:
    return (r["pnet_out"] + m["rgb_out"] * m["roi_out_bbox"] ** 2
            + posenc_dim(r["multires"]) + posenc_dim(r["multires_views"]))


def lidf_spec(cfg: dict):
    """[(name, shape)] of the stage-1 parameters and BatchNorm buffers."""
    m = cfg["model"]
    e = lidf_embed_dim(m)
    return (_resnet_spec(m["rgb_out"]) + _pnet_spec("pnet.", m["pnet_out"],
                                                    m["pnet_gf"])
            + _lin("offset_dec.offset_enc", 1, 16)
            + _mlp_spec("offset_dec.mlp.", e + 16, m["imnet_gf"])
            + _mlp_spec("prob_dec.mlp.", e, m["imnet_gf"]))


def refine_spec(cfg: dict):
    """[(name, shape)] of the RefineNet's parameters."""
    m, r = cfg["model"], cfg["refine"]
    e = refine_embed_dim(m, r)
    return (_pnet_spec("pnet.", r["pnet_out"], r["pnet_gf"])
            + _lin("offset_dec.offset_enc", 1, 16)
            + _mlp_spec("offset_dec.mlp.", e + 16, r["imnet_gf"]))


# -- stage 1 ---------------------------------------------------------------

def batch_norm(x, p, n, train):
    if not train:
        return F.batch_norm(x, p[n + ".running_mean"], p[n + ".running_var"],
                            p[n + ".weight"], p[n + ".bias"], False, 0.0,
                            1e-5)
    mean, ex2 = x.mean((0, 2, 3)), (x * x).mean((0, 2, 3))
    var = (ex2 - mean * mean).clamp(min=0)
    mul = torch.rsqrt(var + 1e-5) * p[n + ".weight"]
    return ((x - mean[:, None, None]) * mul[:, None, None]
            + p[n + ".bias"][:, None, None])


def conv(x, p, n, prec, stride=1, pad=0, dil=1):
    b = p.get(n + ".bias")
    return F.conv2d(prec.q(x), prec.q(p[n + ".weight"]), b, stride, pad, dil)


def resnet(p: T, rgb, train: bool, prec: Precision):
    """rgb (B, H, W, 3) -> (B, H, W, rgb_out) features, output stride 8
    (layer3 dilated 2, layer4 4), resized back bilinearly."""
    h, w = rgb.shape[1:3]
    x = rgb.permute(0, 3, 1, 2)
    x = F.relu(batch_norm(conv(x, p, "resnet.conv1", prec, 2, 3), p,
                          "resnet.bn1", train))
    x = F.max_pool2d(x, 3, 2, 1)
    for stage, blocks in enumerate((3, 4, 6, 3)):
        stride = 2 if stage == 1 else 1
        dil = {2: 2, 3: 4}.get(stage, 1)
        for i in range(blocks):
            n = f"resnet.layer{stage + 1}_{i}"
            s = stride if i == 0 else 1
            y = F.relu(batch_norm(conv(x, p, n + ".conv1", prec, s, dil, dil),
                                  p, n + ".bn1", train))
            y = batch_norm(conv(y, p, n + ".conv2", prec, 1, dil, dil), p,
                           n + ".bn2", train)
            if n + ".down_conv.weight" in p:
                x = batch_norm(conv(x, p, n + ".down_conv", prec, s), p,
                               n + ".down_bn", train)
            x = F.relu(y + x)
    x = conv(x, p, "resnet.fc", prec)
    x = F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False)
    return x.permute(0, 2, 3, 1)


def segment_max(x, seg, n_seg, valid):
    """Max over each segment's valid rows; an empty segment is 0."""
    x = torch.where(valid[:, None], x, torch.full((), float("-inf"),
                                                  device=x.device))
    ids = torch.where(valid, seg.long(), torch.zeros_like(seg.long()))
    out = torch.full((n_seg, x.shape[1]), float("-inf"), device=x.device)
    out = out.scatter_reduce(0, ids[:, None].expand_as(x), x, "amax")
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))


def pointnet(p: T, pre: str, parts, n_seg, prec):
    """Two-stage PointNet over the row parts [(x, seg, valid)], each part
    pooled by itself and the pools joined by an elementwise max."""
    p2s = [F.relu(dense(F.relu(dense(x, p, pre + "l0", prec)), p, pre + "l1",
                        prec)) for x, _, _ in parts]
    v1 = torch.stack([segment_max(p2, s, n_seg, v) for p2, (_, s, v)
                      in zip(p2s, parts)]).amax(0)
    v1 = F.relu(dense(v1, p, pre + "v1_mlp", prec))
    pools = []
    for p2, (_, s, v) in zip(p2s, parts):
        p3 = torch.cat([v1[s.long()], p2], -1)
        p5 = F.relu(dense(F.relu(dense(p3, p, pre + "l3", prec)), p,
                          pre + "l4", prec))
        pools.append(segment_max(p5, s, n_seg, v))
    return F.relu(dense(torch.stack(pools).amax(0), p, pre + "v2_mlp", prec))


def roi_pool(feat, px, py, bidx, inp=8, out=2):
    """Each ray's (out × out) bins of its pixel-centred inp × inp window
    (each bin the mean of a (inp/out)² block; the window shifted inside
    the image at the border), packed (out, out, C)."""
    b, h, w, c = feat.shape
    half, win = inp // 2, inp // out
    pooled = F.avg_pool2d(feat.permute(0, 3, 1, 2), win, 1).permute(0, 2, 3, 1)
    ph, pw = pooled.shape[1:3]
    ph2, pw2 = ph - win * (out - 1), pw - win * (out - 1)
    packed = torch.cat([pooled[:, dy:dy + ph2, dx:dx + pw2]
                        for dy in range(0, out * win, win)
                        for dx in range(0, out * win, win)], -1)
    gy = (py.clamp(half, h - half) - half).clamp(0, ph2 - 1)
    gx = (px.clamp(half, w - half) - half).clamp(0, pw2 - 1)
    lin = (bidx.long() * ph2 + gy) * pw2 + gx
    return packed.reshape(-1, out * out * c)[lin.long()]


def _tail(h1, p, pre, prec):
    h = act(dense(h1, p, pre + "l1", prec))
    h = act(dense(h, p, pre + "l2", prec))
    return dense(h, p, pre + "l3", prec)


def ief(z1, p, pre, n_iter, prec, init=0.001):
    """The IEF decoder from layer 1's product z1 = embedding·W (no bias):
    ``n_iter`` passes add the MLP of [embedding | enc(offset)] to the
    offset; soft-clamped to (0, 1)."""
    w = p[pre + "mlp.l0.weight"]
    wf, b0 = w[:, -16:], p[pre + "mlp.l0.bias"]
    off = torch.full((*z1.shape[:-1], 1), init, device=z1.device)
    for _ in range(n_iter):
        feat = dense(off, p, pre + "offset_enc", prec)
        h1 = act(z1 + prec.q(feat) @ prec.q(wf).t() + b0)
        off = off + _tail(h1, p, pre + "mlp.", prec)
    return soft_clamp01(off)[..., 0]


def imnet(z1, p, pre, prec):
    h1 = act(z1 + p[pre + "mlp.l0.bias"])
    return soft_clamp01(_tail(h1, p, pre + "mlp.", prec))[..., 0]


def _decode_chunk(p, cfg, prec, vox_feat, roi_dir, cells, pos):
    """One chunk of rays: cells (n, kb) rows of ``vox_feat``, roi_dir (n,
    c_roi + c_dir), pos (n, kb, 6) -> (offset, logit), each (n, kb).
    Layer 1 over [vox | roi | enc(enter) | enc(leave) | enc(dir)]: the
    per-pair columns a pair, the per-ray ones once a ray."""
    m = cfg["model"]
    cv, cr = m["pnet_out"], m["rgb_out"] * m["roi_out_bbox"] ** 2
    cp = posenc_dim(m["multires"])
    pair = torch.cat([vox_feat[cells], posenc(pos[..., :3], m["multires"]),
                      posenc(pos[..., 3:], m["multires"])], -1)
    outs = []
    for pre, n_extra in (("offset_dec.", 16), ("prob_dec.", 0)):
        w = p[pre + "mlp.l0.weight"]
        e = w.shape[1] - n_extra
        w_pair = torch.cat([w[:, :cv], w[:, cv + cr:cv + cr + 2 * cp]], 1)
        w_ray = torch.cat([w[:, cv:cv + cr], w[:, cv + cr + 2 * cp:e]], 1)
        z1 = (prec.q(pair) @ prec.q(w_pair).t()
              + (prec.q(roi_dir) @ prec.q(w_ray).t())[:, None, :])
        outs.append(ief(z1, p, pre, m["n_iter"], prec) if n_extra
                    else imnet(z1, p, pre, prec))
    return outs[0], outs[1]


def decode_rays(p: T, cfg: dict, inp: T, feat, vox_feat, *, train: bool,
                use_gt: bool, prec: Precision, chunk_rays: int = 1 << 16):
    """Stage 1's per-ray work: the ROI pool, the decode of each ray's
    nearest kb pair slots, the softmax and argmax over them and the
    predicted point. Rays are decoded in chunks (checkpointed when a
    gradient is taken, so that the reference fits beside nothing)."""
    m, grid = cfg["model"], cfg["_grid"]
    kb = cfg["tpu"]["pairs_budget_per_ray"]
    b, r = inp["pair_valid"].shape[:2]
    dev = feat.device
    bidx = torch.arange(b, device=dev)[:, None].expand(b, r)
    roi = roi_pool(feat, inp["miss_px"], inp["miss_py"], bidx,
                   m["roi_inp_bbox"], m["roi_out_bbox"]).reshape(b, r, -1)
    dirs = inp["miss_dir"]
    roi_dir = torch.cat([roi, posenc(dirs, m["multires_views"])],
                        -1).reshape(b * r, -1)
    cell = inp["pair_cell"][..., :kb]
    valid = inp["pair_valid"][..., :kb]
    t_in, t_out = inp["t_enter"][..., :kb], inp["t_exit"][..., :kb]
    pos = torch.cat([dirs[:, :, None] * t_in[..., None],
                     dirs[:, :, None] * t_out[..., None]], -1).reshape(
        b * r, kb, 6)
    cells = (torch.arange(b, device=dev)[:, None, None] * grid.n_cells
             + cell).reshape(b * r, kb).long()
    offs, logits = [], []
    for s in range(0, b * r, chunk_rays):
        sl = slice(s, s + chunk_rays)
        args = (vox_feat, roi_dir[sl], cells[sl], pos[sl])
        if torch.is_grad_enabled() and dev.type != "meta":
            o, lg = torch.utils.checkpoint.checkpoint(
                _decode_chunk, p, cfg, prec, *args, use_reentrant=False)
        else:
            o, lg = _decode_chunk(p, cfg, prec, *args)
        offs.append(o)
        logits.append(lg)
    off = torch.cat(offs).reshape(b, r, kb)
    logit = torch.cat(logits).reshape(b, r, kb)
    sm = masked_softmax(logit.detach(), valid)
    slot, has = masked_argmax(sm, valid)
    if train and use_gt:
        slot, _ = masked_argmax(inp["pair_label"][..., :kb].float(), valid)
    lo, hi = cfg["grid"]["offset_range"]
    c_off = math.sqrt(3.0) * grid.part
    scaled = (take(off, slot) * (hi - lo) + lo) * c_off
    pred = dirs * (take(t_in, slot) + scaled)[..., None]
    pred = torch.where(has[..., None], pred, torch.zeros((), device=dev))
    return {"roi_feat": roi, "prob_logit": logit, "prob_softmax": sm,
            "pair_valid": valid, "pred_offset": off, "max_slot": slot,
            "has_pair": has, "pred_pos": pred}


def voxel_features(p, cfg, inp, prec, pre="pnet."):
    grid = cfg["_grid"]
    b, n = inp["valid_xyz"].shape[:2]
    x = torch.cat([inp["vox_rel"], inp["valid_rgb"]], -1).reshape(b * n, -1)
    seg = (torch.arange(b, device=x.device)[:, None] * grid.n_cells
           + inp["vox_cell"]).reshape(-1)
    return pointnet(p, pre, [(x, seg, inp["vox_ok"].reshape(-1))],
                    b * grid.n_cells, prec)


def lidf_forward(p: T, cfg: dict, inp: T, *, train: bool, use_gt: bool,
                 prec: Precision) -> T:
    feat = resnet(p, inp["rgb"], train, prec)
    vox = voxel_features(p, cfg, inp, prec)
    return decode_rays(p, cfg, inp, feat, vox, train=train, use_gt=use_gt,
                       prec=prec)


def masked_softmax(x, mask):
    z = torch.where(mask, x, torch.full_like(x, -1e30))
    z = z - z.amax(-1, keepdim=True)
    e = torch.where(mask, torch.exp(z), torch.zeros_like(z))
    return e / e.sum(-1, keepdim=True).clamp(min=1e-30)


def masked_log_softmax(x, mask):
    z = torch.where(mask, x, torch.full_like(x, -1e30))
    mx = z.amax(-1, keepdim=True)
    e = torch.where(mask, torch.exp(z - mx), torch.zeros_like(z))
    lse = mx + torch.log(e.sum(-1, keepdim=True).clamp(min=1e-30))
    return torch.where(mask, x - lse, torch.full_like(x, -1e30))


def masked_argmax(x, mask):
    idx = torch.where(mask, x, torch.full_like(x, float("-inf"))).argmax(-1)
    anyv = mask.any(-1)
    return torch.where(anyv, idx, torch.zeros_like(idx)), anyv


def take(x, idx):
    return x.gather(-1, idx[..., None].long())[..., 0]


# -- stage 2 -------------------------------------------------------------------

def perturb(pred, dirs, prob, gen):
    """Training's noise along each ray, one draw an image: apply, bucket,
    u, in that order, from ``gen``."""
    b = pred.shape[0]
    apply, bucket, u = (geometry.uniform((b,), gen, pred.device)
                        for _ in range(3))
    noise = torch.where(bucket < 0.5, u * 0.05 - 0.05,
                        torch.where(bucket < 0.8, u * 0.05,
                                    torch.where(bucket < 0.9, -0.1 + u * 0.05,
                                                0.05 + u * 0.05)))
    noise = torch.where(apply < prob, noise, torch.zeros_like(noise))
    return pred + noise[:, None, None] * dirs


def refine_iter(p: T, cfg: dict, inp: T, s1: T, pred, prec: Precision):
    """One RefineNet iteration: the end voxel of each prediction (its cell
    when occupied, else stage 1's chosen pair's), the PointNet with the
    predictions put in, and the IEF offset along the ray."""
    m, r_cfg, grid = cfg["model"], cfg["refine"], cfg["_grid"]
    b, r, _ = pred.shape
    dev = pred.device
    ijk = grid.cell_of(pred)
    inb = grid.in_bounds(ijk)
    cand = torch.where(inb, grid.linear_id(ijk), torch.zeros_like(ijk[..., 0]))
    contained = inb & inp["occupancy"].gather(1, cand.long())
    end = torch.where(contained, cand, take(inp["pair_cell"], s1["max_slot"]))
    center = grid.center(grid.unlinear(end), pred.dtype)
    base = torch.arange(b, device=dev)[:, None] * grid.n_cells
    n = inp["valid_xyz"].shape[1]
    parts = [(torch.cat([inp["vox_rel"], inp["valid_rgb"]], -1).reshape(b * n,
                                                                       -1),
              (base + inp["vox_cell"]).reshape(-1), inp["vox_ok"].reshape(-1)),
             (torch.cat([pred - center, inp["miss_rgb"]], -1).reshape(b * r,
                                                                      -1),
              (base + end).reshape(-1),
              (inp["miss_slot"] & s1["has_pair"]).reshape(-1))]
    vox = pointnet(p, "pnet.", parts, b * grid.n_cells, prec)
    end_feat = vox[(base + end).reshape(-1).long()]
    embed = torch.cat([end_feat, s1["roi_feat"].reshape(b * r, -1),
                       posenc(pred, r_cfg["multires"]).reshape(b * r, -1),
                       posenc(inp["miss_dir"], r_cfg["multires_views"]
                              ).reshape(b * r, -1)], -1)
    w = p["offset_dec.mlp.l0.weight"]
    z1 = prec.q(embed) @ prec.q(w[:, :-16]).t()
    off = ief(z1, p, "offset_dec.", r_cfg["n_iter"], prec)
    lo, hi = r_cfg["offset_range"]
    return pred + (off.reshape(b, r) * (hi - lo) + lo)[..., None] \
        * inp["miss_dir"]


def refine_forward(p: T, cfg: dict, inp: T, s1: T, prec: Precision,
                   gen=None, perturb_on=False):
    pred = s1["pred_pos"]
    for it in range(int(cfg["refine"]["forward_times"])):
        if perturb_on and it == 0:
            pred = perturb(pred, inp["miss_dir"],
                           float(cfg["refine"]["perturb_prob"]), gen)
        pred = refine_iter(p, cfg, inp, s1, pred, prec)
    return pred


# -- losses ----------------------------------------------------------------------

def masked_mean(x, mask):
    return (torch.where(mask, x, torch.zeros((), device=x.device)).sum()
            / mask.float().sum().clamp(min=1.0))


def surf_term(inp: T, pred, hw):
    """The surface-normal term of training: the normals of the GT image and
    of the image with each window slot's prediction at its pixel."""
    h, w = hw
    b, r = pred.shape[:2]
    base = inp["xyz_flat"]
    j = inp["miss_rank"] - inp["miss_start"][:, None]
    in_win = inp["miss_mask_flat"] & (j >= 0) & (j < r)
    jj = j.clamp(0, r - 1).long()
    pr = torch.where(in_win[..., None],
                     pred.gather(1, jj[..., None].expand(-1, -1, 3)), base)

    def planar(rows):
        return rows.reshape(b, h, w, 3).permute(0, 3, 1, 2)

    gt_n = geometry.normals_planar(planar(base))[0]
    pr_n = geometry.normals_planar(planar(pr))[0]
    cos = (gt_n * pr_n).sum(1).reshape(b, h * w)
    return masked_mean((1.0 - cos) / 2.0, in_win)


def _surf_w(loss: dict, epoch: int) -> float:
    """The surface-normal weight at ``epoch``; the reference covers the
    configurations without the smoothness and hard-negative terms."""
    if loss.get("smooth_w", 0) or loss.get("hard_neg", False):
        raise NotImplementedError("smooth_w and hard_neg are not covered")
    return loss["surf_norm_w"] * float(epoch >= loss.get("surf_norm_epo", 0))


def lidf_loss(inp: T, out: T, loss: dict, hw, epoch: int):
    slot = inp["miss_slot"]
    pos = masked_mean((out["pred_pos"] - inp["gt_pos"]).abs().mean(-1), slot)
    valid = out["pair_valid"]
    label = inp["pair_label"][..., :valid.shape[-1]]
    gt_slot, _ = masked_argmax(label.float(), valid)
    ce = -take(masked_log_softmax(out["prob_logit"], valid), gt_slot)
    prob = masked_mean(ce, slot & (label & valid).any(-1))
    surf = surf_term(inp, out["pred_pos"], hw)
    return loss["pos_w"] * pos + loss["prob_w"] * prob \
        + _surf_w(loss, epoch) * surf


def refine_loss(inp: T, pred, loss: dict, hw, epoch: int):
    pos = masked_mean((pred - inp["gt_pos"]).abs().mean(-1), inp["miss_slot"])
    return loss["pos_w"] * pos + _surf_w(loss, epoch) * surf_term(inp, pred,
                                                                    hw)


def names_with_grad(spec: List) -> List[str]:
    """The trained leaves of a spec: every parameter but BatchNorm's
    running statistics and counters."""
    return [n for n, _ in spec if not n.endswith(
        (".running_mean", ".running_var", ".num_batches_tracked"))]
