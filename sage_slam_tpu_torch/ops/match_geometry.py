"""Match-geometry factor: 3D point-pair residuals over descriptor matches
(port of sage_slam_tpu/ops/match_geometry.py).

Residual per match m: r_m = d1 h1_m - (d0 R10 h0_m + t10) in frame 1, fair
robust loss per component, no inlier gating (the match set is filtered
before). error = weight * mean over the valid matches of rho; AtA and Atb
scaled the same; with no valid match: error = weight * 10 and zeros.

Three variants:

* ``match_geometry_jac_error`` / ``match_geometry_error``: the full factor
  over [p0(6), p1(6), c0(CS), c1(CS), s0, s1], depths decoded at the
  matched pixels (d = s (b + J c));
* ``loop_mg_jac_error``: pose and scale only, [p0, p1, s0, s1], with frozen
  unscaled depths;
* ``tracker_mg_jac_error``: the tracker's, over the relative pose (and
  scale0).

Every function is batched over leading dims (one edge as in the JAX
package, or E edges at once).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry.se3 import SE3
from . import residuals
from .depth import decode_depth_at
from .robust_loss import fair_error, fair_sqrt_weight


class MatchSet(NamedTuple):
    """Matched point pairs between kf0 and kf1."""

    loc1d_0: torch.Tensor  # [..., M] pixel ids in kf0
    homo_0: torch.Tensor  # [..., M, 3]
    loc1d_1: torch.Tensor  # [..., M] pixel ids in kf1
    homo_1: torch.Tensor  # [..., M, 3]
    valid: torch.Tensor  # [..., M] 0/1


def _point_pair_core(p0: SE3, p1: SE3, homo_0, depth0, homo_1, depth1):
    rot10, t10 = residuals.relative_pose_tensors(p0, p1)
    rh = homo_0 @ rot10.transpose(-1, -2)  # [..., M, 3]
    x1 = depth0[..., None] * rh + t10[..., None, :]
    return rh, depth1[..., None] * homo_1 - x1


def _reduce(rows, diff, valid, factor_weight, loss_param):
    """Robust-weighted rows [..., M, 3, D] and residuals [..., M, 3] ->
    (AtA, Atb, error) normalised by the valid count."""
    sw = fair_sqrt_weight(diff, loss_param)
    err_pt = fair_error(diff, loss_param)
    dim = rows.shape[-1]
    rows = rows * sw[..., None] * valid[..., None, None]
    lead = rows.shape[:-3]
    rows2 = rows.reshape(*lead, -1, dim)
    diffs = (sw * diff * valid[..., None]).reshape(*lead, -1)
    n_valid = torch.sum(valid, dim=-1)
    has = n_valid > 0
    weight = torch.as_tensor(factor_weight, dtype=diff.dtype, device=diff.device)
    inv = torch.where(has, weight / torch.clamp(n_valid, min=1.0), torch.zeros_like(n_valid))
    ata = inv[..., None, None] * (rows2.transpose(-1, -2) @ rows2)
    atb = inv[..., None] * (rows2.transpose(-1, -2) @ diffs[..., None])[..., 0]
    error = torch.where(has, inv * torch.sum(err_pt * valid, dim=-1), weight * 10.0)
    return ata, atb, error


def match_geometry_jac_error(p0: SE3, p1: SE3, code0, code1, scale0, scale1, bias0_flat, jac0_flat,
                             bias1_flat, jac1_flat, matches: MatchSet, factor_weight, loss_param):
    """The full factor (fair) -> (AtA [..., D, D], Atb [..., D], error
    [...], n_valid [...]), D = 14 + 2 CS."""
    d0 = decode_depth_at(bias0_flat, jac0_flat, matches.loc1d_0, code0, scale0)
    d1 = decode_depth_at(bias1_flat, jac1_flat, matches.loc1d_1, code1, scale1)
    rh, diff = _point_pair_core(p0, p1, matches.homo_0, d0, matches.homo_1, d1)
    xw = residuals.points_world(matches.homo_0, d0, p0)
    jac_p0 = residuals.point_jac_pose0(xw, p1.rot)  # [..., M, 3, 6]
    jc0 = torch.take_along_dim(jac0_flat, matches.loc1d_0.long()[..., None], dim=-2)  # [..., M, CS]
    jc1 = torch.take_along_dim(jac1_flat, matches.loc1d_1.long()[..., None], dim=-2)
    s0 = torch.as_tensor(scale0, dtype=d0.dtype, device=d0.device)[..., None]
    s1 = torch.as_tensor(scale1, dtype=d0.dtype, device=d0.device)[..., None]
    jcode0 = rh[..., :, None] * (s0[..., None] * jc0)[..., None, :]  # [..., M, 3, CS]
    jcode1 = -matches.homo_1[..., :, None] * (s1[..., None] * jc1)[..., None, :]
    jscale0 = rh * (d0 / s0)[..., None]
    jscale1 = -matches.homo_1 * (d1 / s1)[..., None]
    rows = torch.cat([jac_p0, -jac_p0, jcode0, jcode1, jscale0[..., None], jscale1[..., None]], dim=-1)
    ata, atb, error = _reduce(rows, diff, matches.valid, factor_weight, loss_param)
    return ata, atb, error, torch.sum(matches.valid, dim=-1)


def match_geometry_error(p0: SE3, p1: SE3, code0, code1, scale0, scale1, bias0_flat, jac0_flat,
                         bias1_flat, jac1_flat, matches: MatchSet, factor_weight, loss_param):
    """Error only of the full factor -> error [...]."""
    d0 = decode_depth_at(bias0_flat, jac0_flat, matches.loc1d_0, code0, scale0)
    d1 = decode_depth_at(bias1_flat, jac1_flat, matches.loc1d_1, code1, scale1)
    _, diff = _point_pair_core(p0, p1, matches.homo_0, d0, matches.homo_1, d1)
    err_pt = fair_error(diff, loss_param)
    n_valid = torch.sum(matches.valid, dim=-1)
    weight = torch.as_tensor(factor_weight, dtype=diff.dtype, device=diff.device)
    return torch.where(n_valid > 0,
                       weight * torch.sum(err_pt * matches.valid, dim=-1) / torch.clamp(n_valid, min=1.0),
                       weight * 10.0)


def loop_mg_jac_error(p0: SE3, p1: SE3, scale0, scale1, unscaled_d0, unscaled_d1, homo_0, homo_1, valid,
                      factor_weight, loss_param):
    """Pose and scale only, with frozen unscaled depths [..., M] ->
    (AtA [..., 14, 14], Atb [..., 14], error [...]); block [p0, p1, s0,
    s1]."""
    s0 = torch.as_tensor(scale0, dtype=unscaled_d0.dtype, device=unscaled_d0.device)[..., None]
    s1 = torch.as_tensor(scale1, dtype=unscaled_d0.dtype, device=unscaled_d0.device)[..., None]
    d0, d1 = unscaled_d0 * s0, unscaled_d1 * s1
    rh, diff = _point_pair_core(p0, p1, homo_0, d0, homo_1, d1)
    jac_p0 = residuals.point_jac_pose0(residuals.points_world(homo_0, d0, p0), p1.rot)
    jscale0 = rh * unscaled_d0[..., None]
    jscale1 = -homo_1 * unscaled_d1[..., None]
    rows = torch.cat([jac_p0, -jac_p0, jscale0[..., None], jscale1[..., None]], dim=-1)
    return _reduce(rows, diff, valid, factor_weight, loss_param)


def tracker_mg_jac_error(rot10, t10, depth0, depth1, homo_0, homo_1, valid, factor_weight,
                         loss_param, scale0=None):
    """The tracker's term: its variables are the relative pose (6) or the
    relative pose and scale0 (7). rot10 [..., 3, 3], t10 [..., 3], depth0
    and depth1 [..., M] (scaled depths at the matched points), homo_0 and
    homo_1 [..., M, 3], valid [..., M] -> (AtA [..., D, D], Atb [..., D],
    error [...])."""
    rh = homo_0 @ rot10.transpose(-1, -2)
    x1 = depth0[..., None] * rh + t10[..., None, :]
    diff = depth1[..., None] * homo_1 - x1  # [..., M, 3]
    rows = residuals.point_jac_left(x1)  # [..., M, 3, 6]
    if scale0 is not None:
        rows = torch.cat([rows, (rh * (depth0 / scale0)[..., None])[..., None]], dim=-1)
    return _reduce(rows, diff, valid, factor_weight, loss_param)
