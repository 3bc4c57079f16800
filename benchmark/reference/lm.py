"""The full-graph LM step, written from the factors' definitions and not
from the program's code: the reference that the BA cell's timed path is
held to.

A keyframe's variables are its pose T (world from camera), its depth code
c and its depth scale s; a step moves the pose on the left, T <- Exp(d) T
with d = [translation, rotation] and Exp the matrix exponential of the
4x4 twist, and adds to code and scale. Per factor, the residual is written
out plainly and its Jacobian with respect to those increments is taken by
forward-mode autograd (``torch.func.jvp`` over the increments' basis). The
factors, as the configuration's solver defines them:

* photometric, keyframe i0's sampled points warped into keyframe i1: per
  level l and channel, r = sqrt(w_l) g (f0 - f1(u_l, v_l)), with g = (z1 >
  eps) x the video mask bilinearly sampled at the warped pixel (a weight,
  held at the linearization point; with ``soft_inlier_gate`` off, the mask
  at the nearest pixel) and f1 the target's feature map sampled
  bilinearly with zero padding; the Jacobian of f1 is the target's feature
  gradient map at the same pixel times d(u_l, v_l)/d(increments). Blocks
  are divided by the sum of g^2 (at least 1); an edge without inliers costs
  10 x the sum of the level weights;
* geometric, the same warp: raw = d1(u, v) - z1 with d1 the target's scaled
  decoded depth sampled bilinearly; residual sqrt_w (z1 - d1) with the
  weight sqrt_w = (z1 > eps) m / sqrt(raw^2 + lp), m the mask at the
  nearest pixel (halves round up), lp = geo_loss_param_factor x the source's
  mean squared depth bias; the Jacobian of d1 at the pixel is the scaled
  depth map's gradient map there, and its code and scale columns are exact.
  Blocks are scaled by geo_factor_weight over the inlier count; the error
  is that scale times the sum of (z1 > eps) log(1 + (m raw)^2 / lp);
* every factor's block is symmetrised and gets 2e-4 x its largest absolute
  row sum on the diagonal;
* priors: the code (w I, w (0 - c), error w mean(c^2)), the first
  keyframe's scale (w / s^2, (w / s)(log s0 - log s), error w (log s -
  log s0)^2) and its pose held at the identity (w I, w (0 - Log T), error
  w |Log T|^2).

Each block is formed in float32 (the configuration's precision), the
normal equations are assembled with ``index_add_`` and solved with
``torch.linalg.solve`` in float64. The LM: the first linearization is
accepted; an iteration linearizes the candidate, accepts it when its error
is below the accepted one (damping / 10, not under its minimum) or rejects
it (damping x 10), solves (H + damping diag(H) + min_damp I) x = b from
the accepted system and retracts the next candidate; after the last
iteration the candidate is kept if its error is below the accepted one.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .slam.ops.pyramid import spatial_grad

BUMP = 2e-4  # the per-factor diagonal bump, relative to the Gerschgorin bound
CHUNK = 32  # edges linearized together


class State(NamedTuple):
    rot: torch.Tensor  # [K, 3, 3] world from camera
    trans: torch.Tensor  # [K, 3]
    code: torch.Tensor  # [K, CS]
    scale: torch.Tensor  # [K]


class Level(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int


class Problem(NamedTuple):
    """A map's keyframes, factors and priors."""

    loc1d: torch.Tensor  # [K, N] sampled pixel ids of each keyframe
    homo: torch.Tensor  # [K, N, 3] their rays
    bias: torch.Tensor  # [K, HW] depth bias
    basis: torch.Tensor  # [K, HW, CS] depth code basis
    feats: tuple  # per level [K, H_l W_l, C] feature maps
    grads: tuple  # per level [K, H_l W_l, 2C] their x then y gradients
    src: torch.Tensor  # [K, L, N, C] each keyframe's features at its points
    avg_sq_bias: torch.Tensor  # [K]
    mask: torch.Tensor  # [HW] video mask
    levels: tuple  # Level per pyramid level
    photo: tuple  # (i0 [E], i1 [E])
    geo: tuple  # (i0 [E], i1 [E])
    scale_target: float  # the first keyframe's scale prior


def hat(w: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], z, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def expmap(d: torch.Tensor) -> torch.Tensor:
    """Exp of twists d [..., 6] = [translation, rotation] -> [..., 4, 4]."""
    top = torch.cat([hat(d[..., 3:]), d[..., :3, None]], -1)
    return torch.linalg.matrix_exp(torch.cat([top, torch.zeros_like(top[..., :1, :])], -2))


def logmap(rot: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """Log of poses near the identity (angle under pi - 1e-3) -> [..., 6]."""
    w = torch.stack([rot[..., 2, 1] - rot[..., 1, 2], rot[..., 0, 2] - rot[..., 2, 0],
                     rot[..., 1, 0] - rot[..., 0, 1]], -1)
    tr = rot[..., 0, 0] + rot[..., 1, 1] + rot[..., 2, 2]
    theta = torch.atan2(0.5 * w.norm(dim=-1), 0.5 * (tr - 1))
    small = theta < 1e-4
    safe = torch.where(small, torch.ones_like(theta), theta)
    omega = torch.where(small, 0.5 + theta**2 / 12, safe / (2 * torch.sin(safe)))[..., None] * w
    k = hat(omega)
    coef = torch.where(small, 1 / 12 + theta**2 / 720,
                       (1 - safe * torch.cos(safe / 2) / (2 * torch.sin(safe / 2))) / safe**2)
    eye = torch.eye(3, dtype=rot.dtype, device=rot.device)
    v_inv = eye - 0.5 * k + coef[..., None, None] * (k @ k)
    return torch.cat([(v_inv @ trans[..., None])[..., 0], omega], -1)


def bilinear(table: torch.Tensor, kf: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
             width: int, height: int) -> torch.Tensor:
    """Keyframe kf [e]'s map table [K, H W, C] at pixels x, y [e, N] ->
    [e, N, C]; each of the four taps counts only inside the image."""
    x = torch.nan_to_num(x, nan=-2.0).clamp(-2.0, width + 1.0)
    y = torch.nan_to_num(y, nan=-2.0).clamp(-2.0, height + 1.0)
    x0, y0 = torch.floor(x), torch.floor(y)
    ax, ay = x - x0, y - y0
    out = 0
    for dx, dy, wt in ((0, 0, (1 - ax) * (1 - ay)), (1, 0, ax * (1 - ay)),
                       (0, 1, (1 - ax) * ay), (1, 1, ax * ay)):
        xi, yi = x0.long() + dx, y0.long() + dy
        inside = (xi >= 0) & (xi < width) & (yi >= 0) & (yi < height)
        idx = yi.clamp(0, height - 1) * width + xi.clamp(0, width - 1)
        out = out + table[kf[:, None], idx] * (wt * inside)[..., None]
    return out


def nearest(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor, width: int,
            height: int) -> torch.Tensor:
    """img [H W] at the nearest pixel of x, y [e, N] (halves round up), 0
    outside."""
    x = torch.nan_to_num(x, nan=-2.0).clamp(-2.0, width + 1.0)
    y = torch.nan_to_num(y, nan=-2.0).clamp(-2.0, height + 1.0)
    xi, yi = torch.floor(x + 0.5).long(), torch.floor(y + 0.5).long()
    inside = (xi >= 0) & (xi < width) & (yi >= 0) & (yi < height)
    return img[yi.clamp(0, height - 1) * width + xi.clamp(0, width - 1)] * inside


def _moved(state: State, kf, d, dc=None, ds=None):
    """Keyframes kf [e] after the increments: pose twist d [e, 6], code
    dc [e, CS], scale ds [e] -> (rot, trans, code, scale)."""
    m = expmap(d)
    rot = m[:, :3, :3] @ state.rot[kf]
    trans = (m[:, :3, :3] @ state.trans[kf][..., None])[..., 0] + m[:, :3, 3]
    code = state.code[kf] if dc is None else state.code[kf] + dc
    scale = state.scale[kf] if ds is None else state.scale[kf] + ds
    return rot, trans, code, scale


def _points(state: State, pb: Problem, i0, i1, p) -> torch.Tensor:
    """Keyframe i0's points in keyframe i1's camera [e, N, 3]; p [e, P]
    holds the increments [d0 (6), d1 (6), code0 (CS), scale0, ...]."""
    cs = state.code.shape[-1]
    r0, t0, c0, s0 = _moved(state, i0, p[:, :6], p[:, 12:12 + cs], p[:, 12 + cs])
    r1, t1, _, _ = _moved(state, i1, p[:, 6:12])
    loc = pb.loc1d[i0]
    depth = s0[:, None] * (pb.bias[i0[:, None], loc]
                           + (pb.basis[i0[:, None], loc] @ c0[:, :, None])[..., 0])
    world = depth[..., None] * (pb.homo[i0] @ r0.transpose(1, 2)) + t0[:, None]
    return (world - t1[:, None]) @ r1


def _pixels(x1: torch.Tensor, front: torch.Tensor, lv: Level):
    z = torch.where(front, x1[..., 2], torch.ones_like(x1[..., 2]))
    return x1[..., 0] / z * lv.fx + lv.cx, x1[..., 1] / z * lv.fy + lv.cy


def _jvp(fn, p: torch.Tensor, n: int):
    """fn(p) and its derivatives along the first n increments, each output
    stacked [n, ...] (forward-mode autograd)."""
    basis = torch.eye(p.shape[1], dtype=p.dtype, device=p.device)[:n, None].expand(n, *p.shape)
    return fn(p), torch.func.vmap(lambda t: torch.func.jvp(fn, (p,), (t,))[1])(basis)


def _bump(h: torch.Tensor) -> torch.Tensor:
    h = 0.5 * (h + h.transpose(-1, -2))
    eye = torch.eye(h.shape[-1], dtype=h.dtype, device=h.device)
    return h + (BUMP * h.abs().sum(-1).amax(-1))[:, None, None] * eye


def _photo(state: State, pb: Problem, i0, i1, cfg, jac: bool):
    """-> (blocks [e, P, P], rhs [e, P], error [e]), P = 13 + CS."""
    cs = state.code.shape[-1]
    e, n_par = i0.shape[0], 13 + cs
    p = torch.zeros(e, 14 + 2 * cs, dtype=state.scale.dtype, device=state.scale.device)
    lv0 = pb.levels[0]
    x1 = _points(state, pb, i0, i1, p)
    front = x1[..., 2] > cfg.dpt_eps

    def coords(q):
        u, v = _pixels(_points(state, pb, i0, i1, q), front, lv0)
        return torch.stack([torch.stack([(u + 0.5) * lv.fx / lv0.fx - 0.5,
                                         (v + 0.5) * lv.fy / lv0.fy - 0.5]) for lv in pb.levels])

    uv, duv = _jvp(coords, p, n_par) if jac else (coords(p), None)  # [(P,) L, 2, e, N]
    u0, v0 = uv[0, 0], uv[0, 1]
    if cfg.soft_inlier_gate:
        mask = pb.mask.reshape(1, -1, 1).expand(pb.src.shape[0], -1, 1)
        gate = front * bilinear(mask, i1, u0, v0, lv0.width, lv0.height)[..., 0]
    else:
        gate = front * nearest(pb.mask, u0, v0, lv0.width, lv0.height)
    c = pb.src.shape[-1]
    h = torch.zeros(e, n_par, n_par, dtype=p.dtype, device=p.device)
    b = torch.zeros(e, n_par, dtype=p.dtype, device=p.device)
    err = torch.zeros(e, dtype=p.dtype, device=p.device)
    for lvl, lv in enumerate(pb.levels):
        sw = math.sqrt(cfg.photo_factor_weights[lvl]) * gate  # [e, N]
        f1 = bilinear(pb.feats[lvl], i1, uv[lvl, 0], uv[lvl, 1], lv.width, lv.height)
        r = sw[..., None] * (pb.src[i0, lvl] - f1)  # [e, N, C]
        err = err + (r * r).sum((1, 2))
        if not jac:
            continue
        g = bilinear(pb.grads[lvl], i1, uv[lvl, 0], uv[lvl, 1], lv.width, lv.height)
        jl = sw[..., None] * (g[..., :c] * duv[:, lvl, 0, ..., None]
                              + g[..., c:] * duv[:, lvl, 1, ..., None])  # [P, e, N, C]
        jl = jl.permute(1, 0, 2, 3).reshape(e, n_par, -1)
        h = h + jl @ jl.transpose(1, 2)
        b = b + (jl @ r.reshape(e, -1, 1))[..., 0]
    n_inl = (gate * gate).sum(-1)
    has = n_inl > 0
    inv = torch.where(has, 1 / n_inl.clamp(min=1), torch.zeros_like(n_inl))
    err = torch.where(has, err * inv, torch.full_like(err, 10 * sum(cfg.photo_factor_weights)))
    return h * inv[:, None, None], b * inv[:, None], err


def _geo(state: State, pb: Problem, i0, i1, cfg, jac: bool):
    """-> (blocks [e, P, P], rhs [e, P], error [e]), P = 14 + 2 CS."""
    cs = state.code.shape[-1]
    e, n_par = i0.shape[0], 14 + 2 * cs
    p = torch.zeros(e, n_par, dtype=state.scale.dtype, device=state.scale.device)
    lv = pb.levels[0]
    k = state.scale.shape[0]
    unscaled = pb.bias + (pb.basis @ state.code[:, :, None])[..., 0]  # [K, HW]
    grad = spatial_grad(unscaled.reshape(k, lv.height, lv.width)).reshape(2, k, -1)
    table = torch.cat([unscaled[..., None], grad.permute(1, 2, 0), pb.basis], -1)
    x1 = _points(state, pb, i0, i1, p)
    front = x1[..., 2] > cfg.dpt_eps
    u, v = _pixels(x1, front, lv)
    at = bilinear(table, i1, u, v, lv.width, lv.height)  # [e, N, 3 + CS]
    inlier = front * nearest(pb.mask, u, v, lv.width, lv.height)
    s1 = state.scale[i1][:, None]

    def model(q):
        """(u, v, z1, d1 at the fixed pixel) under the increments; d1's
        code and scale increments are the last CS + 1 entries."""
        x = _points(state, pb, i0, i1, q)
        uu, vv = _pixels(x, front, lv)
        d1 = (s1 + q[:, -1:]) * (at[..., 0] + (at[..., 3:] @ q[:, 13 + cs:-1, None])[..., 0])
        return torch.stack([uu, vv, torch.where(front, x[..., 2], torch.ones_like(uu)), d1])

    out, dout = _jvp(model, p, n_par) if jac else (model(p), None)
    z1, d1 = out[2], out[3]
    raw = d1 - z1
    lp = (cfg.geo_loss_param_factor * pb.avg_sq_bias[i0])[:, None]
    sqrt_w = inlier * torch.rsqrt(raw * raw + lp)
    n_inl = inlier.sum(-1)
    has = n_inl > 0
    inv = torch.where(has, cfg.geo_factor_weight / n_inl.clamp(min=1), torch.zeros_like(n_inl))
    err = torch.where(has, inv * (front * torch.log1p((inlier * raw) ** 2 / lp)).sum(-1),
                      torch.full_like(n_inl, 10 * cfg.geo_factor_weight))
    if not jac:
        return None, None, err
    g = s1[..., None] * at[..., 1:3]  # the scaled depth's gradient at the pixel
    j = sqrt_w * (dout[:, 2] - g[..., 0] * dout[:, 0] - g[..., 1] * dout[:, 1] - dout[:, 3])
    j = j.transpose(0, 1)  # [e, P, N]
    h = inv[:, None, None] * (j @ j.transpose(1, 2))
    b = inv[:, None] * (j @ (sqrt_w * raw)[..., None])[..., 0]
    return h, b, err


def _slots(i0, i1, cs: int, geo: bool) -> torch.Tensor:
    """Global indices [e, P] of an edge's increments in the map's system
    (per keyframe: pose 6, code CS, scale 1)."""
    bd = 7 + cs
    ar = torch.arange(bd, device=i0.device)
    parts = [i0[:, None] * bd + ar[:6], i1[:, None] * bd + ar[:6], i0[:, None] * bd + ar[6:]]
    if geo:
        parts.append(i1[:, None] * bd + ar[6:])
    return torch.cat(parts, -1)


def linearize(state: State, pb: Problem, cfg, jac: bool = True):
    """-> (H [D, D], b [D] float64, error float) of the whole map, or with
    ``jac`` False only the error."""
    k, cs = state.code.shape
    d = k * (7 + cs)
    dev = state.scale.device
    h = torch.zeros(d * d, dtype=torch.float64, device=dev)
    b = torch.zeros(d, dtype=torch.float64, device=dev)
    err = torch.zeros((), dtype=torch.float64, device=dev)
    for factor, (e0, e1), geo, on in ((_photo, pb.photo, False, cfg.use_photometric),
                                     (_geo, pb.geo, True, cfg.use_geometric)):
        if not on:
            continue
        for s in range(0, e0.shape[0], CHUNK):
            i0, i1 = e0[s:s + CHUNK], e1[s:s + CHUNK]
            hb, bb, eb = factor(state, pb, i0, i1, cfg, jac)
            err = err + eb.double().sum()
            if jac:
                idx = _slots(i0, i1, cs, geo)
                h.index_add_(0, (idx[:, :, None] * d + idx[:, None, :]).reshape(-1),
                             _bump(hb.double()).reshape(-1))
                b.index_add_(0, idx.reshape(-1), bb.double().reshape(-1))
    h = h.reshape(d, d)
    bd = 7 + cs
    code = state.code.double()
    w = cfg.code_factor_weight
    err = err + (w * (code * code).mean(-1)).sum()
    s, ws, st = float(state.scale[0]), cfg.init_scale_prior_weight, pb.scale_target
    pose = logmap(state.rot[0].double(), state.trans[0].double())
    wp = cfg.init_pose_prior_weight
    err = err + (ws * (math.log(s) - math.log(st)) ** 2 if s > 0 else 1e10) + wp * (pose * pose).sum()
    if jac:
        ci = (torch.arange(k, device=dev)[:, None] * bd + 6 + torch.arange(cs, device=dev)).reshape(-1)
        h[ci, ci] += w
        b[ci] -= w * code.reshape(-1)
        si = 6 + cs
        h[si, si] += ws / s**2 if s > 0 else ws
        b[si] += (ws / s) * (math.log(st) - math.log(s)) if s > 0 else 0.0
        pi = torch.arange(6, device=dev)
        h[pi, pi] += wp
        b[:6] -= wp * pose
    return h, b, float(err)


def retract(state: State, x: torch.Tensor) -> State:
    """The state moved by the solution x [K, 7 + CS] (float64)."""
    cs = state.code.shape[-1]
    m = expmap(x[:, :6])
    rot = m[:, :3, :3] @ state.rot.double()
    trans = (m[:, :3, :3] @ state.trans.double()[..., None])[..., 0] + m[:, :3, 3]
    f = state.scale.dtype
    return State(rot.to(f), trans.to(f), (state.code.double() + x[:, 6:6 + cs]).to(f),
                 (state.scale.double() + x[:, 6 + cs]).to(f))


def run(state: State, pb: Problem, cfg, iters: int) -> State:
    """``iters`` LM iterations from ``state`` (see the module note)."""
    f32 = np.float32
    damping, max_damp = f32(cfg.gn_init_damp), f32(cfg.gn_max_damp)
    accepted, error, h, b = state, math.inf, None, None
    candidate = state
    it = 0
    while it < iters and damping <= max_damp:
        hc, bc, ec = linearize(candidate, pb, cfg)
        if ec < error:
            accepted, error, h, b = candidate, ec, hc, bc
            damping = max(damping / f32(cfg.gn_damp_dec_factor), f32(cfg.gn_min_damp))
        else:
            damping = damping * f32(cfg.gn_damp_inc_factor)
        eye = torch.eye(h.shape[0], dtype=h.dtype, device=h.device)
        a = h + float(damping) * torch.diag(torch.diagonal(h)) + cfg.gn_min_damp * eye
        x = torch.linalg.solve(a, b)
        candidate = retract(accepted, x.reshape(state.scale.shape[0], -1))
        it += 1
    if linearize(candidate, pb, cfg, jac=False)[2] < error:
        return candidate
    return accepted
