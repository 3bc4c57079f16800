"""Reprojection factor: 2D pixel residuals over descriptor matches (port of
sage_slam_tpu/ops/reprojection.py).

Residual per match m: r_m = u_matched_1 - proj(T10 * (d0 h0_m)), fair
robust loss per pixel component, gated by warped depth z > eps. Variables
(p0, p1, c0, s0), dim 13+CS, laid out [p0(6), p1(6), c0(CS), s0(1)].
error = (weight / n_inl) sum(rho), AtA and Atb scaled the same; with no
inlier: error = weight * 10 and zeros. ``weight`` is the match set's
inlier ratio times the factor weight; loss_param =
reproj_loss_param_factor * width^2.

Batched over leading dims: poses, codes and scales [...], flats
[..., HW(, CS)], match sets [..., M(, 3|2)], weight [...] (one edge as in
the JAX package, or E edges at once).

``tracker_reproj_jac_error`` is the tracker's variant: its variables are
the relative pose (6) or the relative pose and scale0 (7), with the
Jacobian taken at the warped point directly.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry.se3 import SE3
from . import residuals
from .depth import decode_depth_at
from .robust_loss import fair_error, fair_sqrt_weight


class ReprojMatchSet(NamedTuple):
    loc1d_0: torch.Tensor  # [..., M] pixel ids in kf0
    homo_0: torch.Tensor  # [..., M, 3]
    matched_2d_1: torch.Tensor  # [..., M, 2] pixel coords in frame 1
    valid: torch.Tensor  # [..., M] 0/1


def _residual(p0: SE3, p1: SE3, code0, scale0, bias0_flat, jac0_flat, matches, cam, eps):
    d0 = decode_depth_at(bias0_flat, jac0_flat, matches.loc1d_0, code0, scale0)
    rot10, t10 = residuals.relative_pose_tensors(p0, p1)
    w = residuals.warp(matches.homo_0, d0, rot10, t10, eps)
    pts = residuals.safe_points(w.points_in_1, w.pos_depth)
    u, v = residuals.project_full_res(pts, cam.fx, cam.fy, cam.cx, cam.cy)
    diff = matches.matched_2d_1 - torch.stack([u, v], dim=-1)  # [..., M, 2]
    pos = w.pos_depth.to(diff.dtype) * matches.valid
    return d0, w, pts, diff, pos


def _normalize(weight, n_inl, like):
    weight = torch.as_tensor(weight, dtype=like.dtype, device=like.device)
    has = n_inl > 0
    inv = torch.where(has, weight / torch.clamp(n_inl, min=1.0), torch.zeros_like(n_inl))
    return weight, has, inv


def reprojection_jac_error(p0: SE3, p1: SE3, code0, scale0, bias0_flat, jac0_flat,
                           matches: ReprojMatchSet, cam, weight, loss_param, eps: float):
    """-> (AtA [..., 13+CS, 13+CS], Atb [..., 13+CS], error [...], n_inl [...])."""
    cs = jac0_flat.shape[-1]
    dim = 13 + cs
    d0, w, pts, diff, pos = _residual(
        p0, p1, code0, scale0, bias0_flat, jac0_flat, matches, cam, eps
    )
    sw = fair_sqrt_weight(diff, loss_param) * pos[..., None]
    err_pt = fair_error(diff, loss_param) * pos

    jp = residuals.proj_jac_point(pts, cam.fx, cam.fy)  # [..., M, 2, 3]
    xw = residuals.points_world(matches.homo_0, d0, p0)
    j2d_p0 = jp @ residuals.point_jac_pose0(xw, p1.rot)  # [..., M, 2, 6]
    j2d_dpt = residuals.proj_jac_depth(w.rotated_homo, pts, cam.fx, cam.fy)  # [..., M, 2]
    jc = torch.take_along_dim(jac0_flat, matches.loc1d_0.long()[..., None], dim=-2)
    s0 = torch.as_tensor(scale0, dtype=d0.dtype, device=d0.device)[..., None]
    j2d_code = j2d_dpt[..., None] * (s0[..., None] * jc)[..., None, :]  # [..., M, 2, CS]
    j2d_scale = j2d_dpt * (d0 / s0)[..., None]
    rows = torch.cat([j2d_p0, -j2d_p0, j2d_code, j2d_scale[..., None]], dim=-1)
    rows = rows * sw[..., None]
    lead = rows.shape[:-3]
    rows2 = rows.reshape(*lead, -1, dim)  # [..., 2M, dim]
    diffs = (sw * diff).reshape(*lead, -1)

    n_inl = torch.sum(pos, dim=-1)
    weight, has, inv = _normalize(weight, n_inl, diff)
    ata = inv[..., None, None] * (rows2.transpose(-1, -2) @ rows2)
    atb = inv[..., None] * (rows2.transpose(-1, -2) @ diffs[..., None])[..., 0]
    error = torch.where(has, inv * torch.sum(err_pt, dim=-1), weight * 10.0)
    return ata, atb, error, n_inl


def reprojection_error(p0: SE3, p1: SE3, code0, scale0, bias0_flat, jac0_flat,
                       matches: ReprojMatchSet, cam, weight, loss_param, eps: float):
    """Error-only path -> (error [...], n_inl [...])."""
    _, _, _, diff, pos = _residual(
        p0, p1, code0, scale0, bias0_flat, jac0_flat, matches, cam, eps
    )
    err_pt = fair_error(diff, loss_param) * pos
    n_inl = torch.sum(pos, dim=-1)
    weight, has, _ = _normalize(weight, n_inl, diff)
    error = torch.where(
        has, weight * torch.sum(err_pt, dim=-1) / torch.clamp(n_inl, min=1.0), weight * 10.0
    )
    return error, n_inl


def tracker_reproj_jac_error(rot10, t10, depth0, homo_0, matched_2d_1, valid, cam, weight,
                             loss_param, eps: float, scale0=None):
    """rot10 [..., 3, 3], t10 [..., 3], depth0 [..., M] (scaled depths at
    the matched kf0 points), homo_0 [..., M, 3], matched_2d_1 [..., M, 2],
    valid [..., M] -> (AtA [..., D, D], Atb [..., D], error [...],
    n_inl [...]), D = 6, or 7 with ``scale0``."""
    w = residuals.warp(homo_0, depth0, rot10, t10, eps)
    x1 = residuals.safe_points(w.points_in_1, w.pos_depth)
    u, v = residuals.project_full_res(x1, cam.fx, cam.fy, cam.cx, cam.cy)
    diff = matched_2d_1 - torch.stack([u, v], dim=-1)  # [..., M, 2]
    pos = w.pos_depth.to(diff.dtype) * valid
    sw = fair_sqrt_weight(diff, loss_param) * pos[..., None]
    err_pt = fair_error(diff, loss_param) * pos

    rows = residuals.proj_jac_point(x1, cam.fx, cam.fy) @ residuals.point_jac_left(x1)
    if scale0 is not None:
        j2d_dpt = residuals.proj_jac_depth(w.rotated_homo, x1, cam.fx, cam.fy)  # [..., M, 2]
        rows = torch.cat([rows, (j2d_dpt * (depth0 / scale0)[..., None])[..., None]], dim=-1)
    dim = rows.shape[-1]
    rows = rows * sw[..., None]
    lead = rows.shape[:-3]
    rows2 = rows.reshape(*lead, -1, dim)  # [..., 2M, D]
    diffs = (sw * diff).reshape(*lead, -1)
    n_inl = torch.sum(pos, dim=-1)
    weight, has, inv = _normalize(weight, n_inl, diff)
    ata = inv[..., None, None] * (rows2.transpose(-1, -2) @ rows2)
    atb = inv[..., None] * (rows2.transpose(-1, -2) @ diffs[..., None])[..., 0]
    error = torch.where(has, inv * torch.sum(err_pt, dim=-1), weight * 10.0)
    return ata, atb, error, n_inl
