"""FeatureMatchingGeo: descriptor matching and robust 3D registration (port
of sage_slam_tpu/tracker/matching_geo.py).

Seeded keypoints of the reference keyframe, cycle-consistent NN descriptor
matching, then GNC-TLS registration of the matched 3D point pairs (sim(3)
when a scale estimate is asked for). Gives the matched point sets of the
tracker's reprojection and match-geometry terms, an initial (R, t, scale)
and the inlier ratios of the keyframe and loop decisions.

The keypoints come from ``matcher.select_keypoints(seed, ...)`` (a seeded
CPU ``torch.Generator``; the JAX package's ``jax.random`` draw cannot be
reproduced) unless ``keypoints=`` passes them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import interp
from . import matcher, robust


class MatchGeoResult(NamedTuple):
    matches: matcher.Matches
    inliers: torch.Tensor  # [K] 0/1 registration survivors
    homo0: torch.Tensor  # [K, 3]
    homo1: torch.Tensor  # [K, 3]
    dpts0: torch.Tensor  # [K] reference-frame depths used
    dpts1: torch.Tensor  # [K]
    matched_2d_1: torch.Tensor  # [K, 2]
    guess_rot: torch.Tensor  # [3, 3]
    guess_trans: torch.Tensor  # [3]
    guess_scale: torch.Tensor  # scalar
    relative_desc_inlier_ratio: torch.Tensor  # inliers / cycle-consistent count
    desc_inlier_ratio: torch.Tensor  # inliers / K


def feature_matching_geo(
    seed: int,
    desc0_flat: torch.Tensor,  # [HW, C] reference keyframe descriptors
    desc1_flat: torch.Tensor,  # [HW, C] frame-to-track descriptors
    valid_loc1d: torch.Tensor,  # [V] valid pixel ids (static mask)
    dpts0_flat: torch.Tensor,  # [HW] reference depths (scaled)
    dpts1_flat: torch.Tensor,  # [HW] frame depths (scaled)
    cam,
    num_keypoints: int,
    cyc_consis_thresh: float,
    noise_bound_multiplier: float,
    estimate_scale: bool = False,
    dpt_scale_1=1.0,
    keypoints: torch.Tensor | None = None,  # [K] injected keypoint ids
) -> MatchGeoResult:
    """Degenerate cases surface as zero inlier ratios; no host reads."""
    kps = matcher.select_keypoints(seed, valid_loc1d, num_keypoints) if keypoints is None else keypoints
    m = matcher.cycle_consistent_matches(kps, desc0_flat, desc1_flat, cam.width, cyc_consis_thresh)
    homo0, homo1 = matcher.matches_to_points(m, cam)
    d0 = dpts0_flat[m.loc1d_0]
    d1 = dpts1_flat[m.loc1d_1]

    # registration in the frame-to-track's depth units: keyframe depths are
    # divided by the current frame's scale
    src = (d0 / dpt_scale_1)[:, None] * homo0
    dst = d1[:, None] * homo1
    focal = (cam.fx + cam.fy) / 2.0
    bounds = torch.clamp(noise_bound_multiplier * d1 / focal, min=5.0e-4)
    reg = robust.gnc_tls_registration(src, dst, bounds, m.valid, estimate_scale=estimate_scale)

    cyc_count = torch.clamp(torch.sum(m.valid), min=1.0)
    n_inl = torch.sum(reg.inliers)
    x1, y1 = interp.locations_1d_to_2d(m.loc1d_1, cam.width)
    return MatchGeoResult(
        matches=m,
        inliers=reg.inliers,
        homo0=homo0,
        homo1=homo1,
        dpts0=d0,
        dpts1=d1,
        matched_2d_1=torch.stack([x1, y1], dim=-1),
        guess_rot=reg.rot,
        guess_trans=reg.trans,
        guess_scale=reg.scale,
        relative_desc_inlier_ratio=n_inl / cyc_count,
        desc_inlier_ratio=n_inl / num_keypoints,
    )
