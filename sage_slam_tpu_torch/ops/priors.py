"""Prior factors of the window BA (port of the per-keyframe priors of
sage_slam_tpu/ops/priors.py), batched over a leading keyframe axis K.

* scale prior: error = w (log s - log s_init)^2, AtA = w / s^2,
  Atb = (w / s)(log s_init - log s); a non-positive scale gets a huge
  finite error so the LM loop rejects the step,
* code prior: AtA = w I, Atb = w (c_init - c), error = w mean((c_init - c)^2),
* pose prior: AtA = w I6, Atb = w (log(T_tgt) - log(T)).

The loop-closure factors (rel_pose_scale_factor, rel_pose_factor) belong
to a later slice.
"""

from __future__ import annotations

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
