"""Prior factors of the window BA (port of the per-keyframe priors of
sage_slam_tpu/ops/priors.py), batched over a leading keyframe axis K.

* scale prior: error = w (log s - log s_init)^2, AtA = w / s^2,
  Atb = (w / s)(log s_init - log s); a non-positive scale gets a huge
  finite error so the LM loop rejects the step,
* code prior: AtA = w I, Atb = w (c_init - c), error = w mean((c_init - c)^2),
* pose prior: AtA = w I6, Atb = w (log(T_tgt) - log(T)),

and the pose-graph edges of loop closure, batched over a leading edge axis
E (T10 = T1^-1 T0, rw / sw the rotation / scale weights):

* rel_pose_scale_factor: 7-dim residual [t10/s0 - t10*/s0*;
  sqrt(rw)(Log R10 - Log R10*); sqrt(sw)(log(s1/s0) - log(s1*/s0*))] over
  the block [pose0(6), pose1(6), s0, s1];
* rel_pose_factor: the same without the scale terms, block [pose0, pose1].

The JAX package takes the 6x12 pose Jacobian of [t10/s0; sqrt(rw) Log R10]
by forward-mode AD at zero left tangents. Here it is written out: with
u = R1^T (w0 - w1), R10 -> Exp(u) R10, so the rotation rows are
J_l^-1(Log R10) R1^T [0, I, 0, -I], and t10 moves by
R1^T (v0 - v1 - hat(t0) (w0 - w1)). The scale column of the translation
rows uses the TARGET translation (-t10*/s0^2), as the reference does.
"""

from __future__ import annotations

import math

import torch

from ..geometry import se3 as se3m
from ..geometry.se3 import SE3


def scale_prior(scale, init_scale, weight):
    """scale, init_scale [K] -> (AtA [K, 1, 1], Atb [K, 1], error [K])."""
    ok = scale > 0
    safe = torch.where(ok, scale, torch.ones_like(scale))
    log_diff = torch.log(init_scale) - torch.log(safe)
    ata = (weight / (safe * safe))[:, None, None]
    atb = torch.where(ok, weight / safe * log_diff, torch.zeros_like(safe))[:, None]
    err = torch.where(ok, weight * log_diff**2, torch.full_like(safe, 1e10))
    return ata, atb, err


def code_prior(code, init_code, weight):
    """code, init_code [K, CS] -> (AtA [K, CS, CS], Atb [K, CS], error [K])."""
    k, cs = code.shape
    diff = init_code - code
    eye = torch.eye(cs, dtype=code.dtype, device=code.device)
    ata = (weight * eye).expand(k, cs, cs)
    atb = weight * diff
    err = weight * torch.mean(diff**2, dim=-1)
    return ata, atb, err


def pose_prior(pose: SE3, target: SE3, weight):
    """pose, target [K] -> (AtA [K, 6, 6], Atb [K, 6], error [K])."""
    diff = se3m.se3_log(target) - se3m.se3_log(pose)
    k = diff.shape[0]
    eye = torch.eye(6, dtype=diff.dtype, device=diff.device)
    ata = (weight * eye).expand(k, 6, 6)
    atb = weight * diff
    err = weight * torch.sum(diff**2, dim=-1)
    return ata, atb, err


def _relpose10(p0: SE3, p1: SE3) -> SE3:
    return se3m.compose(se3m.inverse(p1), p0)


def _pose_jacobian(p0: SE3, p1: SE3, log_rot10, trans_scale, sqrt_rw):
    """d[t10 * trans_scale; sqrt_rw Log R10] / d[tangent0, tangent1] at zero
    left tangents -> [E, 6, 12] (see the module note)."""
    r1t = p1.rot.transpose(-1, -2)
    jt = -r1t @ se3m.hat(p0.trans)  # d t10 / d w0
    jr = se3m.so3_left_jacobian_inverse(log_rot10) @ r1t  # d Log R10 / d w0
    zero = torch.zeros_like(r1t)
    top = torch.cat([r1t, jt, -r1t, -jt], dim=-1) * trans_scale[:, None, None]
    bottom = sqrt_rw * torch.cat([zero, jr, zero, -jr], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def rel_pose_scale_factor(p0: SE3, p1: SE3, scale0, scale1, target_pose10: SE3, target_scale0,
                          target_scale1, factor_weight, rot_weight, scale_weight):
    """Loop-closure pose+scale edges: poses, scales and targets [E], the
    factor weight [E] or a scalar -> (AtA [E, 14, 14], Atb [E, 14],
    error [E]). Block layout [0:6] pose0, [6:12] pose1, [12] scale0,
    [13] scale1."""
    e = scale0.shape[0]
    dtype, dev = scale0.dtype, scale0.device
    sqrt_rw, sqrt_sw = math.sqrt(rot_weight), math.sqrt(scale_weight)
    rel = _relpose10(p0, p1)
    log_rel = se3m.so3_log(rel.rot)
    log_tgt = se3m.so3_log(target_pose10.rot)
    cur = torch.cat([rel.trans / scale0[:, None], sqrt_rw * log_rel], dim=-1)
    tgt = torch.cat([target_pose10.trans / target_scale0[:, None], sqrt_rw * log_tgt], dim=-1)
    log_ratio = torch.log(scale1 / scale0)
    log_tgt_ratio = torch.log(target_scale1 / target_scale0)

    jac_pose = _pose_jacobian(p0, p1, log_rel, 1.0 / scale0, sqrt_rw)  # [E, 6, 12]
    zero = torch.zeros((e, 3), dtype=dtype, device=dev)
    col_s0 = torch.cat([-target_pose10.trans / (scale0**2)[:, None], zero], dim=-1)
    jac_scale = torch.stack([col_s0, torch.zeros_like(col_s0)], dim=-1)  # [E, 6, 2]
    scale_row = torch.cat([
        torch.zeros((e, 12), dtype=dtype, device=dev),
        (sqrt_sw * (-1.0 / scale0))[:, None], (sqrt_sw * (1.0 / scale1))[:, None],
    ], dim=-1)[:, None]  # [E, 1, 14]
    jac = torch.cat([torch.cat([jac_pose, jac_scale], dim=-1), scale_row], dim=-2)  # [E, 7, 14]
    diff = torch.cat([tgt - cur, (sqrt_sw * (log_tgt_ratio - log_ratio))[:, None]], dim=-1)

    w = torch.as_tensor(factor_weight, dtype=dtype, device=dev).expand(e)
    jt = jac.transpose(-1, -2)
    ata = w[:, None, None] * (jt @ jac)
    atb = w[:, None] * (jt @ diff[..., None])[..., 0]
    trans_err = torch.sum((rel.trans / scale0[:, None] - target_pose10.trans / target_scale0[:, None]) ** 2,
                          dim=-1)
    rot_err = rot_weight * torch.sum((log_rel - log_tgt) ** 2, dim=-1)
    scale_err = scale_weight * (log_ratio - log_tgt_ratio) ** 2
    return ata, atb, w * (trans_err + rot_err + scale_err)


def rel_pose_factor(p0: SE3, p1: SE3, target_pose10: SE3, factor_weight, rot_weight):
    """Pose-graph edges without scale: poses and targets [E] -> (AtA
    [E, 12, 12], Atb [E, 12], error [E])."""
    e = p0.trans.shape[0]
    dtype, dev = p0.trans.dtype, p0.trans.device
    sqrt_rw = math.sqrt(rot_weight)
    rel = _relpose10(p0, p1)
    log_rel = se3m.so3_log(rel.rot)
    log_tgt = se3m.so3_log(target_pose10.rot)
    jac = _pose_jacobian(p0, p1, log_rel, torch.ones(e, dtype=dtype, device=dev), sqrt_rw)
    cur = torch.cat([rel.trans, sqrt_rw * log_rel], dim=-1)
    diff = torch.cat([target_pose10.trans, sqrt_rw * log_tgt], dim=-1) - cur
    w = torch.as_tensor(factor_weight, dtype=dtype, device=dev).expand(e)
    jt = jac.transpose(-1, -2)
    ata = w[:, None, None] * (jt @ jac)
    atb = w[:, None] * (jt @ diff[..., None])[..., 0]
    err = w * (torch.sum((rel.trans - target_pose10.trans) ** 2, dim=-1)
               + rot_weight * torch.sum((log_rel - log_tgt) ** 2, dim=-1))
    return ata, atb, err
