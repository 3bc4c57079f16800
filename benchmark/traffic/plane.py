"""The mapper's plane video, rendered on the card from the seed.

A copy of the repo's ``synthetic.mapper_scene``: a camera translating along
a quarter circle (with a forward drift of 0.002 per frame) over a textured
fronto-parallel plane at depth 1, seen through a circular endoscope-like
mask, so each frame is the texture shifted by the camera's motion. The
texture's random sinusoids come from ``numpy.random.default_rng(seed)`` as
the original draws them; the frames are computed as torch operations in
float64.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

MASK_RADIUS = 0.46  # of the image width


class Scene(NamedTuple):
    images: torch.Tensor  # [F, 3, H, W] float32 in [0, 1], on the card
    trans: np.ndarray  # [F, 3] world-from-camera translations (no rotation)
    intrinsics: tuple  # (fx, fy, cx, cy) at the networks' output resolution
    mask_in: np.ndarray  # [H, W]
    mask_out: np.ndarray  # [H/2, W/2]


def arc(num_points: int, radius: float) -> np.ndarray:
    angles = np.linspace(0.0, np.pi / 2, num_points)
    return np.stack([radius * np.sin(angles), radius * (1 - np.cos(angles)),
                     0.002 * np.arange(num_points)], axis=-1).astype(np.float32)


def render(num_frames: int, seed: int, height: int, width: int, radius: float, device) -> Scene:
    rng = np.random.default_rng(int(seed))
    n_waves = 12
    freq = rng.uniform(0.04, 0.35, size=(3, n_waves, 2)) * rng.choice([-1, 1], size=(3, n_waves, 2))
    phase = rng.uniform(0, 2 * np.pi, size=(3, n_waves))
    amp = rng.uniform(0.2, 1.0, size=(3, n_waves))
    amp /= amp.sum(axis=1, keepdims=True) * 2.2
    f_in = width * 1.1
    trans = arc(num_frames, radius)
    f64 = dict(dtype=torch.float64, device=device)
    yy, xx = torch.meshgrid(torch.arange(height, **f64), torch.arange(width, **f64), indexing="ij")
    t = torch.as_tensor(trans, **f64)
    depth = (1.0 - t[:, 2])[:, None, None]
    sx = (xx - width / 2) * depth + f_in * t[:, 0, None, None]  # [F, H, W]
    sy = (yy - height / 2) * depth + f_in * t[:, 1, None, None]
    fq = torch.as_tensor(freq, **f64)
    arg = (fq[None, ..., 0, None, None] * sx[:, None, None] + fq[None, ..., 1, None, None] * sy[:, None, None]
           + torch.as_tensor(phase, **f64)[None, ..., None, None])  # [F, 3, waves, H, W]
    images = 0.5 + (torch.as_tensor(amp, **f64)[None, ..., None, None] * torch.sin(arg)).sum(2)
    ys, xs = np.mgrid[:height, :width].astype(np.float64)
    mask_in = (((xs - (width - 1) / 2) ** 2 + (ys - (height - 1) / 2) ** 2)
               <= (MASK_RADIUS * width) ** 2).astype(np.float32)
    h, w = height // 2, width // 2
    return Scene(images.clamp(0.0, 1.0).to(torch.float32), trans,
                 (f_in / 2, f_in / 2, w / 2 - 0.5, h / 2 - 0.5), mask_in, mask_in[::2, ::2].copy())
