"""Fair robust loss of the match-based factors (port of
sage_slam_tpu/ops/robust_loss.py), per residual component:

  rho(d)    = 2 (|d|/s - log(1 + |d|/s)),  s = sqrt(loss_param)
  sqrt_w(d) = sqrt(1 / (loss_param (1 + |d|/s)))
"""

from __future__ import annotations

import torch


def fair_error(diff: torch.Tensor, loss_param) -> torch.Tensor:
    """Elementwise fair cost, summed over the last axis."""
    s = torch.sqrt(torch.as_tensor(loss_param, dtype=diff.dtype, device=diff.device))
    n = torch.abs(diff) / s
    return 2.0 * torch.sum(n - torch.log1p(n), dim=-1)


def fair_sqrt_weight(diff: torch.Tensor, loss_param) -> torch.Tensor:
    """Elementwise sqrt IRLS weight."""
    lp = torch.as_tensor(loss_param, dtype=diff.dtype, device=diff.device)
    n = torch.abs(diff) / torch.sqrt(lp)
    return torch.sqrt(1.0 / (lp * (1.0 + n)))
