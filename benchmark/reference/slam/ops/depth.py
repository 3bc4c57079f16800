"""Depth decoding (port of sage_slam_tpu/ops/depth.py).

``depth = scale * (bias + dpt_jac_code @ code)``: depth is linear in the
latent code, so its code Jacobian is the network's basis output. Both
functions broadcast over leading batch dims (one keyframe or E edges).
"""

from __future__ import annotations

import torch


def _scale(scale, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(scale, dtype=like.dtype, device=like.device)[..., None]


def decode_depth(bias_flat, jac_code_flat, code, scale) -> torch.Tensor:
    """Full-image decode: bias [..., HW], jac [..., HW, CS], code [..., CS],
    scale [...] -> [..., HW]."""
    return _scale(scale, bias_flat) * (bias_flat + (jac_code_flat @ code[..., None])[..., 0])

