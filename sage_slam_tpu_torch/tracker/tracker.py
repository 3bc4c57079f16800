"""Camera tracker: 6-DoF / 7-DoF LM alignment of a frame to a keyframe
(port of sage_slam_tpu/tracker/tracker.py).

* lazy Jacobian refresh (skipped while the relative error change stays
  below jac_update_err_inc_threshold), damping on diag(AtA) with an
  accept/reject inner loop, convergence on max|Atb| or the largest
  relative parameter increment, left-multiplied se3 updates of the
  relative pose;
* 6-DoF tracking: photometric + reprojection terms; 7-DoF (loop
  verification): photometric (+scale) + match-geometry (+scale).

Variables are the relative pose T_ck (keyframe -> current frame), plus a
depth scale in the 7-DoF variant. The 6x6 / 7x7 Gram is two float32
matmuls (TF32 off), as the JAX package forms it with two dot_generals
outside any Pallas kernel.

The JAX package runs the LM in one ``lax.while_loop``. Here it is a Python
loop whose decisions are taken on the host from float32 values read off
the device, with float32 arithmetic (numpy), so they match JAX's: one read
per inner damping step, which carries the refreshed error, the convergence
flag and the first candidate's error together. An iteration that accepts
its first candidate costs one read.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..geometry import interp
from ..geometry.camera import CameraPyramid
from ..geometry.se3 import se3_exp, so3_log
from ..ops import match_geometry as mg_ops
from ..ops import photometric
from ..ops import reprojection as rp_ops
from ..ops.robust_loss import fair_error
from ..utils import timing


class TrackerRef(NamedTuple):
    """Per-keyframe data the tracker needs (prepared once per keyframe)."""

    photo_homo0: torch.Tensor  # [N, 3] sampled photometric rays
    photo_dpts0: torch.Tensor  # [N] scaled depths at those rays
    cat_photo_feats0: torch.Tensor  # [L, N, C] source features per level


class TrackerTarget(NamedTuple):
    """Frame-to-track data: its pyramids and mask, and optionally its
    sampling tables (ops/photometric.FrameTables of the one frame)."""

    feat_pyr: torch.Tensor  # [C, T]
    grad_pyr: torch.Tensor  # [2, C, T]
    mask_flat: torch.Tensor  # [HW] full-res video mask
    tables: photometric.FrameTables | None = None

    def with_packed(self, cam_pyr: CameraPyramid) -> "TrackerTarget":
        """This target with its sampling tables built (once, before the LM
        loop)."""
        if self.tables is not None:
            return self
        return self._replace(tables=photometric.FrameTables.build(
            self.feat_pyr, self.grad_pyr, self.mask_flat, cam_pyr))


def _photo_warp(rot10, t10, ref: TrackerRef, cam0, eps: float):
    """Warp the keyframe's samples into the frame -> (rh [3, N], x1 [3, N]
    with z set to 1 where gated out, pos [N], u [N], v [N])."""
    rh = rot10 @ ref.photo_homo0.T
    x1 = ref.photo_dpts0[None] * rh + t10[:, None]
    front = x1[2] > eps
    z = torch.where(front, x1[2], torch.ones_like(x1[2]))
    x1 = torch.stack([x1[0], x1[1], z])
    u = x1[0] / x1[2] * cam0.fx + cam0.cx
    v = x1[1] / x1[2] * cam0.fy + cam0.cy
    return rh, x1, front.to(rh.dtype), u, v


def _samples(target: TrackerTarget, cam_pyr: CameraPyramid, u, v, with_grad: bool, soft: bool):
    """The frame sampled at (u, v) on every level -> (per level [3C, N]
    (features then x and y gradients) or [C, N], within [N])."""
    tables = target.with_packed(cam_pyr).tables
    c = target.feat_pyr.shape[0]
    if with_grad:
        packed, dense, c_out = tables.packed_fg, tables.dense_fg, 3 * c
    else:
        packed, dense, c_out = tables.packed_feat, tables.dense_feat, c
    base = torch.zeros(1, dtype=torch.int64, device=u.device)
    out, within = photometric._target_samples_cm(
        target.mask_flat, cam_pyr, u[None], v[None], base, packed, dense, c_out, soft=soft
    )
    return [o[0] for o in out], within[0]


def tracker_photo_jac_error(rot10, t10, ref: TrackerRef, target: TrackerTarget,
                            cam_pyr: CameraPyramid, weights, eps: float, scale0=None,
                            soft: bool = False):
    """Photometric term -> (AtA [D, D], Atb [D], error, n_inl), D = 6, or
    7 with ``scale0``. Channel-major: per-point level-weighted gradient
    Gram (gxx, gxy, gyy) and gradient.residual (hx, hy), K-rows [D, N],
    then the Gram as two matmuls."""
    cam0 = cam_pyr[0]
    rh, x1, pos, u, v = _photo_warp(rot10, t10, ref, cam0, eps)
    c = target.feat_pyr.shape[0]
    fgs, within = _samples(target, cam_pyr, u, v, True, soft)
    gate2 = (pos * within) ** 2

    gxx = gxy = gyy = hx = hy = torch.zeros_like(gate2)
    err_total = torch.zeros((), dtype=gate2.dtype, device=gate2.device)
    for lvl in range(cam_pyr.levels):
        cam_l = cam_pyr[lvl]
        fg = fgs[lvl]  # [3C, N]
        d = ref.cat_photo_feats0[lvl].T - fg[:c]
        gx = fg[c : 2 * c]
        gy = fg[2 * c :]
        wl = weights[lvl]
        rx = cam_l.fx / cam0.fx
        ry = cam_l.fy / cam0.fy
        gxx = gxx + (wl * rx * rx) * torch.sum(gx * gx, dim=0)
        gxy = gxy + (wl * rx * ry) * torch.sum(gx * gy, dim=0)
        gyy = gyy + (wl * ry * ry) * torch.sum(gy * gy, dim=0)
        hx = hx + (wl * rx) * torch.sum(gx * d, dim=0)
        hy = hy + (wl * ry) * torch.sum(gy * d, dim=0)
        err_total = err_total + wl * torch.sum(gate2 * torch.sum(d * d, dim=0))
    n_inl = torch.sum(gate2)
    gxx, gxy, gyy = gate2 * gxx, gate2 * gxy, gate2 * gyy
    hx, hy = gate2 * hx, gate2 * hy

    # K-rows: the pinhole Jacobian rows times [I | -hat(x1)]
    x, y, z = x1[0], x1[1], x1[2]
    inv_z = 1.0 / z
    xz = x * inv_z
    yz = y * inv_z
    fxz = cam0.fx * inv_z
    fyz = cam0.fy * inv_z
    zero = torch.zeros_like(x)
    kx_cols = [fxz, zero, -fxz * xz, -fxz * xz * y, fxz * (z + xz * x), -fxz * y]
    ky_cols = [zero, fyz, -fyz * yz, fyz * (-z - yz * y), fyz * yz * x, fyz * x]
    if scale0 is not None:
        dx = cam0.fx * (rh[0] * inv_z - x * rh[2] * inv_z * inv_z)
        dy = cam0.fy * (rh[1] * inv_z - y * rh[2] * inv_z * inv_z)
        kx_cols.append(dx * (ref.photo_dpts0 / scale0))
        ky_cols.append(dy * (ref.photo_dpts0 / scale0))
    kx = torch.stack(kx_cols)  # [D, N]
    ky = torch.stack(ky_cols)

    kgx = gxx[None] * kx + gxy[None] * ky
    kgy = gxy[None] * kx + gyy[None] * ky
    ata = kx @ kgx.T + ky @ kgy.T
    atb = kx @ hx + ky @ hy

    w_sum = photometric._weight_sum(weights, gate2)
    has = n_inl > 0
    inv = torch.where(has, 1.0 / torch.clamp(n_inl, min=1.0), torch.zeros_like(n_inl))
    error = torch.where(has, err_total * inv, w_sum * 10.0)
    return ata * inv, atb * inv, error, n_inl


def tracker_photo_error(rot10, t10, ref: TrackerRef, target: TrackerTarget,
                        cam_pyr: CameraPyramid, weights, eps: float, soft: bool = False):
    """Error-only photometric term for the LM inner loop -> (error,
    n_inl)."""
    _, _, pos, u, v = _photo_warp(rot10, t10, ref, cam_pyr[0], eps)
    f1s, within = _samples(target, cam_pyr, u, v, False, soft)
    g2 = (pos * within) ** 2
    err_total = torch.zeros((), dtype=g2.dtype, device=g2.device)
    for lvl in range(cam_pyr.levels):
        err_pt = g2 * torch.sum((ref.cat_photo_feats0[lvl].T - f1s[lvl]) ** 2, dim=0)
        err_total = err_total + weights[lvl] * torch.sum(err_pt)
    n_inl = torch.sum(g2)
    w_sum = photometric._weight_sum(weights, g2)
    error = torch.where(n_inl > 0, err_total / torch.clamp(n_inl, min=1.0), w_sum * 10.0)
    return error, n_inl


class TrackTerms(NamedTuple):
    """Optional match-based terms of the tracker LM."""

    # reprojection (6-DoF tracking): matched 2D pixels in frame 1
    reproj_dpts0: torch.Tensor | None = None  # [M]
    reproj_homo0: torch.Tensor | None = None  # [M, 3]
    reproj_matched_2d: torch.Tensor | None = None  # [M, 2]
    reproj_valid: torch.Tensor | None = None  # [M]
    reproj_weight: float | torch.Tensor = 0.0
    reproj_loss_param: float = 1.0
    # match geometry (7-DoF loop verification)
    mg_dpts0: torch.Tensor | None = None
    mg_homo0: torch.Tensor | None = None
    mg_dpts1: torch.Tensor | None = None
    mg_homo1: torch.Tensor | None = None
    mg_valid: torch.Tensor | None = None
    mg_weight: float | torch.Tensor = 0.0
    mg_loss_param: float = 1.0


class LMResult(NamedTuple):
    rot: torch.Tensor  # [3, 3] final relative rotation
    trans: torch.Tensor  # [3]
    scale: torch.Tensor  # scalar (7-DoF; unchanged in 6-DoF)
    error: torch.Tensor  # scalar, on the device
    iterations: int


@timing.span("tracker.lm_track")
def lm_track(init_rot, init_trans, ref: TrackerRef, target: TrackerTarget,
             cam_pyr: CameraPyramid, cfg, terms: TrackTerms = TrackTerms(),
             use_photo: bool = True, with_scale: bool = False, init_scale=1.0,
             max_iters: int | None = None) -> LMResult:
    """The tracker's LM loop (see the module note).

    cfg needs: init_damp, min_damp, max_damp, damp_dec_factor,
    damp_inc_factor, min_grad_thresh, min_param_inc_thresh,
    jac_update_err_inc_threshold, max_num_iters, photo_factor_weights,
    dpt_eps; optionally coarse_to_fine and soft_inlier_gate."""
    res = _lm_track(init_rot, init_trans, ref, target, cam_pyr, cfg, terms, use_photo, with_scale,
                    init_scale, max_iters)
    timing.count("lm.iters", res.iterations)
    return res


def _lm_track(init_rot, init_trans, ref, target, cam_pyr, cfg, terms, use_photo, with_scale,
              init_scale, max_iters) -> LMResult:
    target = target.with_packed(cam_pyr)
    budget = max_iters if max_iters is not None else cfg.max_num_iters
    weights = cfg.photo_factor_weights
    if getattr(cfg, "coarse_to_fine", False) and use_photo and len(weights) >= 3:
        # two phases: align on the two coarsest levels only (their basin
        # spans several fine-level pixels), then refine with every level
        coarse = tuple(0.0 if lvl < len(weights) - 2 else weights[lvl] for lvl in range(len(weights)))
        cfg_coarse = dataclasses.replace(cfg, coarse_to_fine=False, photo_factor_weights=coarse)
        cfg_fine = dataclasses.replace(cfg, coarse_to_fine=False)
        half = max(budget // 2, 1)
        r1 = _lm_track(init_rot, init_trans, ref, target, cam_pyr, cfg_coarse, terms, use_photo,
                       with_scale, init_scale, half)
        r2 = _lm_track(r1.rot, r1.trans, ref, target, cam_pyr, cfg_fine, terms, use_photo,
                       with_scale, r1.scale if with_scale else init_scale, budget - half)
        return LMResult(r2.rot, r2.trans, r2.scale, r2.error, r1.iterations + r2.iterations)

    dim = 7 if with_scale else 6
    dtype, dev = init_trans.dtype, init_trans.device
    eps = cfg.dpt_eps
    soft = getattr(cfg, "soft_inlier_gate", False)
    cam0 = cam_pyr[0]
    eye = torch.eye(dim, dtype=dtype, device=dev)
    f32 = np.float32

    def jac_error(rot, trans, scale):
        ata = torch.zeros((dim, dim), dtype=dtype, device=dev)
        atb = torch.zeros((dim,), dtype=dtype, device=dev)
        err = torch.zeros((), dtype=dtype, device=dev)
        s0 = scale if with_scale else None
        if use_photo:
            a, b, e, _ = tracker_photo_jac_error(rot, trans, ref, target, cam_pyr, weights, eps,
                                                 scale0=s0, soft=soft)
            ata, atb, err = ata + a, atb + b, err + e
        if terms.reproj_dpts0 is not None:
            a, b, e, _ = rp_ops.tracker_reproj_jac_error(
                rot, trans, terms.reproj_dpts0, terms.reproj_homo0, terms.reproj_matched_2d,
                terms.reproj_valid, cam0, terms.reproj_weight, terms.reproj_loss_param, eps,
                scale0=s0,
            )
            ata, atb, err = ata + a, atb + b, err + e
        if terms.mg_dpts0 is not None:
            a, b, e = mg_ops.tracker_mg_jac_error(
                rot, trans, terms.mg_dpts0, terms.mg_dpts1, terms.mg_homo0, terms.mg_homo1,
                terms.mg_valid, terms.mg_weight, terms.mg_loss_param, scale0=s0,
            )
            ata, atb, err = ata + a, atb + b, err + e
        return ata, atb, err

    def error_only(rot, trans):
        err = torch.zeros((), dtype=dtype, device=dev)
        if use_photo:
            err = err + tracker_photo_error(rot, trans, ref, target, cam_pyr, weights, eps, soft=soft)[0]
        if terms.reproj_dpts0 is not None:
            err = err + _reproj_error(rot, trans, terms, cam0, eps)
        if terms.mg_dpts0 is not None:
            err = err + _mg_error(rot, trans, terms)
        return err

    def apply_delta(rot, trans, scale, sol):
        d = se3_exp(sol[:6])
        return d.rot @ rot, d.rot @ trans + d.trans, scale + sol[6] if with_scale else scale

    def converged(rot, trans, scale, atb, sol):
        params = [trans, so3_log(rot)] + ([scale.reshape(1)] if with_scale else [])
        max_inc = torch.max(sol / (torch.abs(torch.cat(params)) + 1e-8))
        return (torch.max(torch.abs(atb)) < cfg.min_grad_thresh) | (max_inc < cfg.min_param_inc_thresh)

    def solve(ata, atb, damp):
        damped = ata + float(damp) * torch.diag(torch.diagonal(ata))
        sol, info = torch.linalg.solve_ex(damped + 1e-12 * eye, atb)
        # a singular system gives inf/NaN in JAX, which the step zeroes
        return torch.where(torch.isfinite(sol) & (info == 0), sol, torch.zeros_like(sol))

    def rel_change(curr, prev):
        with np.errstate(over="ignore"):
            return abs(curr - prev) / max(prev, f32(1e-20))

    rot, trans = init_rot, init_trans
    scale = torch.as_tensor(init_scale, dtype=dtype, device=dev)
    ata, atb, err_dev = jac_error(rot, trans, scale)
    curr_dev = err_dev
    curr = prev = f32(0.0)  # curr is read with the first iteration's decisions
    damp = f32(cfg.init_damp)
    max_damp, min_damp = f32(cfg.max_damp), f32(cfg.min_damp)
    refresh_thresh = f32(cfg.jac_update_err_inc_threshold)
    it = 0
    done = False
    while it < budget and not done:
        # lazy Jacobian refresh; the first iteration's would recompute
        # (ata0, atb0, err0) from the same state, so it is decided after
        # err0 is read
        refresh = it == 0 or rel_change(curr, prev) > refresh_thresh
        if refresh and it > 0:
            ata, atb, err_dev = jac_error(rot, trans, scale)
        sol = solve(ata, atb, damp)
        conv = converged(rot, trans, scale, atb, sol)
        cand = apply_delta(rot, trans, scale, sol)
        cand_dev = error_only(cand[0], cand[1])
        host = torch.stack([err_dev, conv.to(dtype), cand_dev]).cpu().numpy()
        if refresh:
            curr_dev, curr = err_dev, host[0]
            if it == 0:
                refresh = rel_change(curr, prev) > refresh_thresh
        new_prev = curr if refresh else prev
        it += 1
        if host[1] > 0:  # converged: the step is not applied
            prev = new_prev
            done = True
            break
        # inner damping loop: accept on a strict decrease, stop at max_damp
        t_damp, cand_err = damp, host[2]
        while True:
            accept = cand_err < curr
            if accept or t_damp >= max_damp:
                break
            t_damp = min(max(t_damp * f32(cfg.damp_inc_factor), min_damp), max_damp)
            cand = apply_delta(rot, trans, scale, solve(ata, atb, t_damp))
            cand_dev = error_only(cand[0], cand[1])
            cand_err = cand_dev.cpu().numpy()[()]
        prev = new_prev
        if accept:
            rot, trans, scale = cand
            curr_dev, curr = cand_dev, cand_err
            damp = min(max(t_damp / f32(cfg.damp_dec_factor), min_damp), max_damp)
        else:
            damp = t_damp
            done = True
    return LMResult(rot, trans, scale, curr_dev, it)


def _reproj_error(rot10, t10, terms: TrackTerms, cam, eps: float):
    rh = terms.reproj_homo0 @ rot10.T
    x1 = terms.reproj_dpts0[:, None] * rh + t10
    pos = (x1[:, 2] > eps).to(rh.dtype) * terms.reproj_valid
    u = x1[:, 0] / x1[:, 2] * cam.fx + cam.cx
    v = x1[:, 1] / x1[:, 2] * cam.fy + cam.cy
    diff = terms.reproj_matched_2d - torch.stack([u, v], dim=-1)
    err_pt = fair_error(diff, terms.reproj_loss_param) * pos
    n_inl = torch.sum(pos)
    weight = torch.as_tensor(terms.reproj_weight, dtype=rh.dtype, device=rh.device)
    return torch.where(n_inl > 0, weight * torch.sum(err_pt) / torch.clamp(n_inl, min=1.0),
                       weight * 10.0)


def _mg_error(rot10, t10, terms: TrackTerms):
    rh = terms.mg_homo0 @ rot10.T
    x1 = terms.mg_dpts0[:, None] * rh + t10
    diff = terms.mg_dpts1[:, None] * terms.mg_homo1 - x1
    err_pt = fair_error(diff, terms.mg_loss_param) * terms.mg_valid
    n_valid = torch.sum(terms.mg_valid)
    weight = torch.as_tensor(terms.mg_weight, dtype=rh.dtype, device=rh.device)
    return torch.where(n_valid > 0, weight * torch.sum(err_pt) / torch.clamp(n_valid, min=1.0),
                       weight * 10.0)


def area_inlier_motion(valid_dpts0, valid_homo0, rot10, t10, cam, mask_flat, eps: float):
    """The device part of the area / inlier / motion metrics: warped 2D
    points, their validity, the inlier ratio and the normalized average
    motion. The convex-hull areas are taken on the host (convex_hull_area)
    from the returned points."""
    rh = valid_homo0 @ rot10.T
    x1 = valid_dpts0[:, None] * rh + t10
    pos = (x1[:, 2] > eps).to(rh.dtype)
    u = x1[:, 0] / x1[:, 2] * cam.fx + cam.cx
    v = x1[:, 1] / x1[:, 2] * cam.fy + cam.cy
    # nearest mask sample with align_corners=true normalization; torch.round
    # is half-to-even like jnp.round, and the index is clipped as JAX clips
    xi = interp._int_coord(torch.round(u * (cam.width - 1) / cam.width), cam.width)
    yi = interp._int_coord(torch.round(v * (cam.height - 1) / cam.height), cam.height)
    inb = (xi >= 0) & (xi < cam.width) & (yi >= 0) & (yi < cam.height)
    idx = torch.clamp(yi, 0, cam.height - 1) * cam.width + torch.clamp(xi, 0, cam.width - 1)
    within = mask_flat[idx] * inb.to(rh.dtype) * pos

    u0 = valid_homo0[:, 0] * cam.fx + cam.cx
    v0 = valid_homo0[:, 1] * cam.fy + cam.cy
    motion = torch.sqrt((u - u0) ** 2 + (v - v0) ** 2)
    avg_motion = torch.sum(motion * pos) / torch.clamp(torch.sum(pos), min=1.0)
    diag = (cam.width**2 + cam.height**2) ** 0.5
    return dict(
        warped_2d=torch.stack([u, v], dim=-1),
        source_2d=torch.stack([u0, v0], dim=-1),
        within=within,
        pos=pos,
        inlier_ratio=torch.sum(within) / valid_homo0.shape[0],
        average_motion=avg_motion / diag,
    )


def convex_hull_area(points) -> float:
    """Monotone-chain convex hull area of 2D points on the host (numpy)."""
    pts = np.asarray(points, dtype=np.float64)
    pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]
    if len(pts) < 3:
        return 0.0

    def cross2(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    def half(iterable):
        out = []
        for p in iterable:
            while len(out) >= 2 and cross2(out[-2], out[-1], p) <= 0:
                out.pop()
            out.append(p)
        return out

    lower = half(pts)
    upper = half(pts[::-1])
    hull = np.array(lower[:-1] + upper[:-1])
    x, y = hull[:, 0], hull[:, 1]
    return float(0.5 * np.abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1))))
