"""Shared warp geometry for the factor kernels (port of the part of
sage_slam_tpu/ops/residuals.py that the window-BA path uses).

Conventions: ``pose_wk`` = world-from-keyframe; the relative pose
``T_10 = T_1^-1 T_0`` maps kf0 camera points into kf1's camera frame.
"""

from __future__ import annotations

import torch

from ..geometry.se3 import SE3


def relative_pose_tensors(p0: SE3, p1: SE3):
    """R10 = R1^T R0, t10 = R1^T (t0 - t1), batched over leading dims
    (float32 products; TF32 off)."""
    r1t = p1.rot.transpose(-1, -2)
    rot10 = r1t @ p0.rot
    t10 = (r1t @ (p0.trans - p1.trans)[..., None])[..., 0]
    return rot10, t10
