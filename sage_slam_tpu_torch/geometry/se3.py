"""SE(3) utilities with the reference system's tangent conventions.

Port of sage_slam_tpu/geometry/se3.py. Conventions:

* tangent layout is ``[translation(3), rotation(3)]``,
* retract is LEFT-multiplicative: ``T_new = Exp(delta) * T``,
* ``local(a, b)`` is the *raw* translation of ``b * a^-1`` (no V^-1) and
  ``Log(R_b R_a^-1)`` for rotation,
* the exponential uses the smooth small-angle series below
  ``|omega|^2 < 1e-8`` (PARITY.md, deviation 3).

Everything is batched over leading dims. Poses are ``(rot [..., 3, 3],
trans [..., 3])``. Matrix products run in full float32 (TF32 is off, see
device.set_f32_precision), as the JAX package pins Precision.HIGHEST.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


def _rotv(rot, v):
    return (rot @ v[..., None])[..., 0]


class SE3(NamedTuple):
    """A rigid transform: x_out = rot @ x + trans."""

    rot: torch.Tensor  # [..., 3, 3]
    trans: torch.Tensor  # [..., 3]

    @staticmethod
    def identity(batch_shape=(), dtype=torch.float32, device=None) -> "SE3":
        eye = torch.eye(3, dtype=dtype, device=device)
        rot = eye.expand(*batch_shape, 3, 3).clone()
        trans = torch.zeros((*batch_shape, 3), dtype=dtype, device=device)
        return SE3(rot, trans)

    @property
    def batch_shape(self):
        return self.trans.shape[:-1]

    def matrix(self) -> torch.Tensor:
        """[..., 4, 4] homogeneous matrix."""
        bottom = torch.zeros(
            (*self.batch_shape, 1, 4), dtype=self.rot.dtype,
            device=self.rot.device,
        )
        bottom[..., 0, 3] = 1.0
        top = torch.cat([self.rot, self.trans[..., :, None]], dim=-1)
        return torch.cat([top, bottom], dim=-2)


def hat(omega: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: [..., 3] -> [..., 3, 3]."""
    ox, oy, oz = omega[..., 0], omega[..., 1], omega[..., 2]
    zero = torch.zeros_like(ox)
    return torch.stack(
        [
            torch.stack([zero, -oz, oy], dim=-1),
            torch.stack([oz, zero, -ox], dim=-1),
            torch.stack([-oy, ox, zero], dim=-1),
        ],
        dim=-2,
    )


def _exp_coefficients(omega: torch.Tensor):
    """Smooth Rodrigues coefficients A = sin(t)/t, B = (1-cos(t))/t^2,
    C = (t-sin(t))/t^3 as functions of t^2 = |omega|^2, with the Taylor
    series below t^2 < 1e-8 (se3.py:81-100 of the JAX package)."""
    t2 = torch.sum(omega**2, dim=-1)
    small = t2 < 1e-8
    one = torch.ones_like(t2)
    t = torch.sqrt(torch.where(small, one, t2))
    st, ct = torch.sin(t), torch.cos(t)
    safe_t2 = torch.where(small, one, t2)
    a = torch.where(small, 1.0 - t2 / 6.0, st / t)
    b = torch.where(small, 0.5 - t2 / 24.0, (1.0 - ct) / safe_t2)
    c = torch.where(small, 1.0 / 6.0 - t2 / 120.0, (t - st) / (safe_t2 * t))
    return a, b, c


def so3_exp(omega: torch.Tensor) -> torch.Tensor:
    """Rodrigues exponential [..., 3] -> [..., 3, 3]."""
    a, b, _ = _exp_coefficients(omega)
    k = hat(omega)
    k2 = k @ k
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device).expand(k.shape)
    return eye + a[..., None, None] * k + b[..., None, None] * k2


def se3_exp(tau: torch.Tensor) -> SE3:
    """Exp of tangent [trans(3), rot(3)] -> SE3."""
    v, omega = tau[..., :3], tau[..., 3:6]
    a, b, c = _exp_coefficients(omega)
    k = hat(omega)
    k2 = k @ k
    eye = torch.eye(3, dtype=tau.dtype, device=tau.device).expand(k.shape)
    rot = eye + a[..., None, None] * k + b[..., None, None] * k2
    big_v = eye + b[..., None, None] * k + c[..., None, None] * k2
    return SE3(rot, _rotv(big_v, v))


def so3_log(rot: torch.Tensor) -> torch.Tensor:
    """Log map of SO(3): [..., 3, 3] -> [..., 3] (angle*axis), with the
    small-angle series near 0 and the diagonal extraction near pi."""
    trace = rot[..., 0, 0] + rot[..., 1, 1] + rot[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    small = cos_theta > 1.0 - 1e-6
    theta = torch.arccos(torch.where(small, torch.zeros_like(cos_theta), cos_theta))
    w = torch.stack(
        [
            rot[..., 2, 1] - rot[..., 1, 2],
            rot[..., 0, 2] - rot[..., 2, 0],
            rot[..., 1, 0] - rot[..., 0, 1],
        ],
        dim=-1,
    )
    sin_theta = torch.sin(theta)
    theta_sq_small = 3.0 - trace
    factor = torch.where(
        small,
        0.5 + theta_sq_small / 12.0,
        theta / torch.where(small, torch.ones_like(sin_theta), 2.0 * sin_theta),
    )
    omega = factor[..., None] * w
    near_pi = theta > (math.pi - 1e-3)

    # R = I + 2*hat(a)^2 at theta=pi => a_i^2 = (R_ii + 1)/2; signs from the
    # off-diagonal sums relative to the dominant axis
    diag = torch.stack([rot[..., 0, 0], rot[..., 1, 1], rot[..., 2, 2]], dim=-1)
    axis = torch.sqrt(torch.clamp((diag + 1.0) * 0.5, 1e-12, 1.0))
    one = torch.ones_like(trace)
    sx = torch.where(rot[..., 2, 1] - rot[..., 1, 2] < 0, -one, one)
    sy = torch.where(rot[..., 0, 2] - rot[..., 2, 0] < 0, -one, one)
    sz = torch.where(rot[..., 1, 0] - rot[..., 0, 1] < 0, -one, one)
    axy = rot[..., 0, 1] + rot[..., 1, 0]
    axz = rot[..., 0, 2] + rot[..., 2, 0]
    ayz = rot[..., 1, 2] + rot[..., 2, 1]
    dominant = torch.argmax(axis, dim=-1)
    sign_x = torch.where(
        dominant == 0, one,
        torch.where(dominant == 1, torch.sign(axy), torch.sign(axz)),
    )
    sign_y = torch.where(
        dominant == 1, one,
        torch.where(dominant == 0, torch.sign(axy), torch.sign(ayz)),
    )
    sign_z = torch.where(
        dominant == 2, one,
        torch.where(dominant == 0, torch.sign(axz), torch.sign(ayz)),
    )
    sign_x = torch.where(sign_x == 0, sx, sign_x)
    sign_y = torch.where(sign_y == 0, sy, sign_y)
    sign_z = torch.where(sign_z == 0, sz, sign_z)
    pi_branch = theta[..., None] * (
        axis * torch.stack([sign_x, sign_y, sign_z], dim=-1)
    )
    return torch.where(near_pi[..., None], pi_branch, omega)


def compose(a: SE3, b: SE3) -> SE3:
    """a * b (apply b first, then a)."""
    return SE3(a.rot @ b.rot, _rotv(a.rot, b.trans) + a.trans)


def inverse(p: SE3) -> SE3:
    rot_t = p.rot.transpose(-1, -2)
    return SE3(rot_t, -_rotv(rot_t, p.trans))


def act(p: SE3, x: torch.Tensor) -> torch.Tensor:
    """Apply transform to points [..., 3]."""
    return _rotv(p.rot, x) + p.trans


def retract(p: SE3, delta: torch.Tensor) -> SE3:
    """Left-multiplicative retract: Exp(delta) * p."""
    d = se3_exp(delta)
    return SE3(d.rot @ p.rot, _rotv(d.rot, p.trans) + d.trans)


def local(origin: SE3, other: SE3) -> torch.Tensor:
    """Chart at `origin` mapping `other` to the tangent space: raw
    translation of other * origin^-1 and Log of its rotation."""
    rel_rot = other.rot @ origin.rot.transpose(-1, -2)
    t = other.trans - _rotv(rel_rot, origin.trans)
    return torch.cat([t, so3_log(rel_rot)], dim=-1)


def relative_pose(a: SE3, b: SE3) -> SE3:
    """b expressed in frame a: a^-1 * b."""
    return compose(inverse(a), b)


def pose_distance(
    a: SE3, b: SE3, trans_weight: float = 1.0, rot_weight: float = 1.0
) -> torch.Tensor:
    """Weighted pose distance ignoring roll (only the first two
    components of the relative so3 log enter the rotation term)."""
    rel = relative_pose(a, b)
    omega = so3_log(rel.rot)
    drot = torch.linalg.norm(omega[..., :2], dim=-1)
    dtrans = torch.linalg.norm(rel.trans, dim=-1)
    return dtrans * trans_weight + drot * rot_weight


def se3_log(p: SE3) -> torch.Tensor:
    """Proper SE(3) log (V^-1 applied), tangent = [trans, rot]."""
    omega = so3_log(p.rot)
    return torch.cat([_rotv(so3_left_jacobian_inverse(omega), p.trans), omega], dim=-1)


def so3_left_jacobian_inverse(omega: torch.Tensor) -> torch.Tensor:
    """J_l^-1(omega) = I - hat/2 + (1/t^2 - (1 + cos t)/(2 t sin t)) hat^2
    [..., 3] -> [..., 3, 3] (V^-1 of the SE(3) log; d Log(Exp(u) R)/du at
    u = 0 for omega = Log R), with the series below t = 1e-5."""
    theta = torch.linalg.norm(omega, dim=-1)
    k = hat(omega)
    k2 = k @ k
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device).expand(k.shape)
    theta_sq = theta**2
    small = theta < 1e-5
    small_f = small.to(theta.dtype)
    safe_theta_sq = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    coef = torch.where(
        small,
        1.0 / 12.0 + theta_sq / 720.0,
        (
            1.0
            - theta * torch.cos(theta / 2.0)
            / (2.0 * torch.sin(theta / 2.0) + small_f)
        )
        / safe_theta_sq,
    )
    return eye - 0.5 * k + coef[..., None, None] * k2
