"""Match-geometry factor: 3D point-pair residuals over descriptor matches
(port of sage_slam_tpu/ops/match_geometry.py, the tracker's variant only).

Residual per match m: r_m = d1 h1_m - (d0 R10 h0_m + t10) in frame 1, fair
robust loss per component, no inlier gating (the match set is filtered
before). error = weight * mean over the valid matches of rho; AtA and Atb
scaled the same; with no valid match: error = weight * 10 and zeros.
"""

from __future__ import annotations

import torch

from . import residuals
from .robust_loss import fair_error, fair_sqrt_weight


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
    sw = fair_sqrt_weight(diff, loss_param)
    err_pt = fair_error(diff, loss_param)

    rows = residuals.point_jac_left(x1)  # [..., M, 3, 6]
    if scale0 is not None:
        rows = torch.cat([rows, (rh * (depth0 / scale0)[..., None])[..., None]], dim=-1)
    dim = rows.shape[-1]
    rows = rows * sw[..., None] * valid[..., None, None]
    lead = rows.shape[:-3]
    rows2 = rows.reshape(*lead, -1, dim)  # [..., 3M, D]
    diffs = (sw * diff * valid[..., None]).reshape(*lead, -1)
    n_valid = torch.sum(valid, dim=-1)
    has = n_valid > 0
    weight = torch.as_tensor(factor_weight, dtype=diff.dtype, device=diff.device)
    inv = torch.where(has, weight / torch.clamp(n_valid, min=1.0), torch.zeros_like(n_valid))
    ata = inv[..., None, None] * (rows2.transpose(-1, -2) @ rows2)
    atb = inv[..., None] * (rows2.transpose(-1, -2) @ diffs[..., None])[..., 0]
    error = torch.where(has, inv * torch.sum(err_pt * valid, dim=-1), weight * 10.0)
    return ata, atb, error
