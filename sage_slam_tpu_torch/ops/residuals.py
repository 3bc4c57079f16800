"""Shared warp + Jacobian geometry for the factor kernels (port of
sage_slam_tpu/ops/residuals.py).

Conventions: ``pose_wk`` = world-from-keyframe; the relative pose
``T_10 = T_1^-1 T_0`` maps kf0 camera points into kf1's camera frame; pose
tangents are left-multiplicative [trans, rot], and the point Jacobian of
pose1 is exactly the negative of pose0's.

Every function takes points ``[..., N, 3]`` and poses with the matching
leading dims (``[...]``), so one call serves one edge as in the JAX package
or E edges at once.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry.se3 import SE3


class WarpResult(NamedTuple):
    rotated_homo: torch.Tensor  # [..., N, 3] R10 @ homo0
    points_in_1: torch.Tensor  # [..., N, 3] d0 * rotated_homo + t10
    pos_depth: torch.Tensor  # [..., N] bool: z > eps


def relative_pose_tensors(p0: SE3, p1: SE3):
    """R10 = R1^T R0, t10 = R1^T (t0 - t1), batched over leading dims
    (float32 products; TF32 off)."""
    r1t = p1.rot.transpose(-1, -2)
    rot10 = r1t @ p0.rot
    t10 = (r1t @ (p0.trans - p1.trans)[..., None])[..., 0]
    return rot10, t10


def warp(homo0, depth0, rot10, t10, eps: float) -> WarpResult:
    """Rigid warp of kf0 rays into frame 1: homo0 [..., N, 3], depth0
    [..., N], rot10 [..., 3, 3], t10 [..., 3]."""
    rh = homo0 @ rot10.transpose(-1, -2)
    x1 = depth0[..., None] * rh + t10[..., None, :]
    return WarpResult(rh, x1, x1[..., 2] > eps)


def safe_points(points: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """The z of depth-gated-out points set to 1, so 1/z stays finite (a 0
    gate times inf would be NaN)."""
    z = torch.where(pos, points[..., 2], torch.ones_like(points[..., 2]))
    return torch.cat([points[..., :2], z[..., None]], dim=-1)


def project_full_res(points: torch.Tensor, fx, fy, cx, cy):
    """Pinhole projection at full resolution, no depth clamp -> (u, v)."""
    z = points[..., 2]
    return points[..., 0] / z * fx + cx, points[..., 1] / z * fy + cy


def proj_jac_point(points_in_1: torch.Tensor, fx, fy) -> torch.Tensor:
    """d(proj2d)/d(point_in_1) -> [..., N, 2, 3]."""
    inv_z = 1.0 / points_in_1[..., 2]
    x_z = points_in_1[..., 0] * inv_z
    y_z = points_in_1[..., 1] * inv_z
    zero = torch.zeros_like(inv_z)
    row0 = torch.stack([fx * inv_z, zero, -fx * x_z * inv_z], dim=-1)
    row1 = torch.stack([zero, fy * inv_z, -fy * y_z * inv_z], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def point_jac_left(points: torch.Tensor) -> torch.Tensor:
    """[I | -hat(X)]: the Jacobian of a point X [..., N, 3] under a
    left-multiplied [trans, rot] tangent of its transform -> [..., N, 3, 6]."""
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    zero = torch.zeros_like(x)
    one = torch.ones_like(x)
    return torch.stack(
        [
            torch.stack([one, zero, zero, zero, z, -y], dim=-1),
            torch.stack([zero, one, zero, -z, zero, x], dim=-1),
            torch.stack([zero, zero, one, y, -x, zero], dim=-1),
        ],
        dim=-2,
    )


def point_jac_pose0(points_world: torch.Tensor, rot1: torch.Tensor) -> torch.Tensor:
    """d(point_in_1)/d(pose0 tangent) = R1^T [I | -hat(Xw)]: points_world
    [..., N, 3], rot1 [..., 3, 3] -> [..., N, 3, 6]."""
    return rot1.transpose(-1, -2)[..., None, :, :] @ point_jac_left(points_world)


def proj_jac_depth(rotated_homo, points_in_1, fx, fy) -> torch.Tensor:
    """d(proj2d)/d(depth0) -> [..., N, 2]."""
    inv_z = 1.0 / points_in_1[..., 2]
    jx = fx * (rotated_homo[..., 0] * inv_z
               - points_in_1[..., 0] * rotated_homo[..., 2] * inv_z * inv_z)
    jy = fy * (rotated_homo[..., 1] * inv_z
               - points_in_1[..., 1] * rotated_homo[..., 2] * inv_z * inv_z)
    return torch.stack([jx, jy], dim=-1)


def points_world(homo0, depth0, p0: SE3) -> torch.Tensor:
    """Xw = d0 * R0 homo0 + t0 -> [..., N, 3]."""
    return depth0[..., None] * (homo0 @ p0.rot.transpose(-1, -2)) + p0.trans[..., None, :]
