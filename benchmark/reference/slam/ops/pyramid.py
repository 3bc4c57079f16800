"""Feature / mask pyramids and spatial gradients (port of
sage_slam_tpu/ops/pyramid.py).

* masked Gaussian pyramid: 3x3 binomial kernel [[1,2,1],[2,4,2],[1,2,1]]/16,
  stride 2, padding 1, normalized by the smoothed mask + 1e-8,
* mask pyramid: nearest-neighbor downsample by 2 (even rows/cols),
* spatial gradient: replicate-pad central differences * 0.5.

Outputs use the concatenated flat layout ``[C, N0+N1+...]`` /
``[2, C, N0+N1+...]`` that every factor gathers from. The convolution runs
in float32: cuDNN's TF32 default is switched off by the entry points
(device.set_f32_precision).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

GAUSS_KERNEL = (
    (1.0 / 16, 2.0 / 16, 1.0 / 16),
    (2.0 / 16, 4.0 / 16, 2.0 / 16),
    (1.0 / 16, 2.0 / 16, 1.0 / 16),
)


def spatial_grad(feat: torch.Tensor) -> torch.Tensor:
    """[C, H, W] -> [2, C, H, W]; grad_x then grad_y; replicate border."""
    padded = F.pad(feat[None], (1, 1, 1, 1), mode="replicate")[0]
    h, w = feat.shape[-2], feat.shape[-1]
    gx = 0.5 * (padded[:, 1 : h + 1, 2 : w + 2] - padded[:, 1 : h + 1, 0:w])
    gy = 0.5 * (padded[:, 2 : h + 2, 1 : w + 1] - padded[:, 0:h, 1 : w + 1])
    return torch.stack([gx, gy], dim=0)


def _gauss_down(img: torch.Tensor) -> torch.Tensor:
    """Stride-2 3x3 Gaussian conv with zero padding 1 on [C, H, W]."""
    k = torch.tensor(GAUSS_KERNEL, dtype=img.dtype, device=img.device)
    return F.conv2d(img[:, None], k[None, None], stride=2, padding=1)[:, 0]


def mask_pyramid(mask: torch.Tensor, num_levels: int) -> Tuple[torch.Tensor, ...]:
    """Nearest-neighbor 2x downsampled masks [H, W] per level
    (src = floor(dst * 2), i.e. even rows/cols)."""
    out = [mask]
    cur = mask
    for _ in range(num_levels - 1):
        cur = cur[::2, ::2]
        out.append(cur)
    return tuple(out)


def gaussian_pyramid_with_grad(
    feat: torch.Tensor,  # [C, H, W]
    masks: Tuple[torch.Tensor, ...],  # per-level [H_l, W_l] valid masks
    num_levels: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked Gaussian pyramid + gradients in flat concatenated layout ->
    (feat_pyr [C, sum(N_l)], grad_pyr [2, C, sum(N_l)])."""
    c = feat.shape[0]
    feats = []
    grads = []
    cur = feat
    for lvl in range(num_levels):
        if lvl > 0:
            m = masks[lvl - 1].to(cur.dtype)[None]
            cur = _gauss_down(cur * m) / (_gauss_down(m) + 1.0e-8)
        g = spatial_grad(cur)
        feats.append(cur.reshape(c, -1))
        grads.append(g.reshape(2, c, -1))
    return torch.cat(feats, dim=-1), torch.cat(grads, dim=-1)
