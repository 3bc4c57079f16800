"""Robust 3D-3D registration, GNC-TLS (port of
sage_slam_tpu/tracker/robust.py; the TEASER++ replacement).

  repeat: (R, t) = weighted closed-form alignment; r_i = ||dst_i - R src_i - t||;
          TLS weights w_i from r_i^2 against the noise bounds c_i^2 and mu;
          mu <- mu * gnc_factor.

Per-point noise bounds: noise_bound_multiplier * dst depth bias / focal,
at least 5e-4. A fixed number of iterations, no host reads.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class RegistrationResult(NamedTuple):
    rot: torch.Tensor  # [3, 3]
    trans: torch.Tensor  # [3]
    scale: torch.Tensor  # scalar (1 unless estimate_scale)
    inliers: torch.Tensor  # [M] 0/1 residual <= noise bound
    weights: torch.Tensor  # [M] final GNC weights


def _weighted_horn(src, dst, w, estimate_scale: bool = False):
    """Closed-form weighted alignment dst ~ s R src + t (Umeyama)."""
    wsum = torch.clamp(torch.sum(w), min=1e-8)
    mu_s = torch.sum(w[:, None] * src, dim=0) / wsum
    mu_d = torch.sum(w[:, None] * dst, dim=0) / wsum
    s = src - mu_s
    d = dst - mu_d
    cov = (w[:, None] * d).T @ s
    u, sv, vt = torch.linalg.svd(cov)
    fix = torch.ones(3, dtype=cov.dtype, device=cov.device)
    fix = torch.cat([fix[:2], torch.linalg.det(u @ vt)[None]])
    rot = u @ torch.diag(fix) @ vt
    if estimate_scale:
        scale = torch.sum(sv * fix) / torch.clamp(torch.sum(w[:, None] * s**2), min=1e-12)
    else:
        scale = torch.ones((), dtype=src.dtype, device=src.device)
    trans = mu_d - scale * (rot @ mu_s)
    return rot, trans, scale


def gnc_tls_registration(src, dst, noise_bounds, valid, num_iters: int = 20,
                         gnc_factor: float = 1.4, estimate_scale: bool = False):
    """src, dst [M, 3], noise_bounds [M], valid [M] 0/1 -> RegistrationResult."""
    c2 = torch.clamp(noise_bounds, min=5.0e-4) ** 2
    valid = valid.to(src.dtype)

    def residual_sq(rot, trans, scale):
        pred = scale * (src @ rot.T) + trans
        return torch.sum((dst - pred) ** 2, dim=-1)

    rot, trans, scl = _weighted_horn(src, dst, valid, estimate_scale)
    r2 = residual_sq(rot, trans, scl)
    max_r2 = torch.max(torch.where(valid > 0, r2, torch.zeros_like(r2)))
    cbar2 = torch.mean(c2)
    mu = torch.clamp(cbar2 / torch.clamp(2.0 * max_r2 - cbar2, min=1e-9), min=1e-6)

    def tls_weights(r2, mu):
        rhat = torch.sqrt(torch.clamp(r2, min=1e-18))
        mid = torch.sqrt(c2) * torch.sqrt(mu * (mu + 1.0)) / rhat - mu
        upper = (mu + 1.0) / mu * c2
        lower = mu / (mu + 1.0) * c2
        return torch.where(
            r2 >= upper,
            torch.zeros_like(r2),
            torch.where(r2 <= lower, torch.ones_like(r2), torch.clamp(mid, 0.0, 1.0)),
        )

    w = valid
    for _ in range(num_iters):
        w = tls_weights(residual_sq(rot, trans, scl), mu) * valid
        rot, trans, scl = _weighted_horn(src, dst, w, estimate_scale)
        mu = mu * gnc_factor
    r2 = residual_sq(rot, trans, scl)
    inliers = ((r2 <= c2) & (valid > 0)).to(src.dtype)
    return RegistrationResult(rot, trans, scl, inliers, w)


def translation_inlier_filter(src, dst, depth_bias_dst, focal: float, valid,
                              noise_bound_multiplier: float = 2.0, num_iters: int = 20):
    """The reference's TEASER usage: per-point noise bounds from the dst
    depth bias over focal length -> inlier mask [M]."""
    bounds = torch.clamp(noise_bound_multiplier * depth_bias_dst / focal, min=5.0e-4)
    return gnc_tls_registration(src, dst, bounds, valid, num_iters).inliers
