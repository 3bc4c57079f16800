"""Bilinear / nearest gather primitives with the reference's border semantics.

Port of sage_slam_tpu/geometry/interp.py. All sampling uses *zero padding
per corner*: each bilinear corner contributes only if it lies within the
image bounds. Level coordinates map a full-resolution pixel ``p`` to level
``l`` as ``(p + 0.5) * (size_l / size_0) - 0.5``.

Batching: where the JAX functions are vmapped over edges, these take
coordinates ``x, y`` of shape ``[..., N]`` (for example ``[E, N]``) and an
``offset`` that is an int or a tensor of shape ``x.shape[:-1]``; outputs
carry the same leading dims.

Index safety. JAX clamps out-of-range gathers; torch on CUDA raises a
device-side assert. Every index here is clipped into its table as the JAX
code clips it, and a float coordinate is first clamped to a small range
around the image (``[-2, size + 1]``, NaN mapped to -2) before its cast to
an integer, because casting a huge or non-finite float is undefined in
torch. Clamping there changes no result: the bounds weights and clips of a
coordinate outside the image are the same before and after.

The JAX package pins coordinates with an XLA optimization barrier
(``interp._pin``) so that every consumer sees one rounding of the same
value. Eager torch materializes each coordinate tensor exactly once, so
the barrier has no counterpart here.
"""

from __future__ import annotations

import torch


def _int_coord(f: torch.Tensor, size: int) -> torch.Tensor:
    """Integer-valued float (floor or round of a coordinate) -> int64,
    clamped to [-2, size + 1] first (see module docstring)."""
    return torch.nan_to_num(f, nan=-2.0).clamp(-2.0, size + 1.0).long()


def _offset(offset, x: torch.Tensor):
    if isinstance(offset, torch.Tensor):
        return offset.long()[..., None]
    return offset


def _take_cols(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table [R, M] gathered at column indices idx [..., N] -> [..., R, N]."""
    vals = table.index_select(-1, idx.reshape(-1))
    return vals.reshape(table.shape[0], *idx.shape).movedim(0, -2)


def level_coords(x, y, ratio_x: float, ratio_y: float):
    """Map full-res pixel coords to a pyramid level (half-pixel convention)."""
    return (x + 0.5) * ratio_x - 0.5, (y + 0.5) * ratio_y - 0.5


def bilinear_flat(
    img_flat: torch.Tensor,  # [C, total] flattened image(s), row-major per level
    x: torch.Tensor,  # [..., N] pixel x (level coords)
    y: torch.Tensor,
    width: int,
    height: int,
    offset=0,
) -> torch.Tensor:
    """Zero-padding bilinear gather from a flattened image -> [..., C, N]."""
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx0 = (x0 + 1.0) - x
    wy0 = (y0 + 1.0) - y
    wx1 = 1.0 - wx0
    wy1 = 1.0 - wy0
    xi0 = _int_coord(x0, width)
    yi0 = _int_coord(y0, height)
    xi1 = xi0 + 1
    yi1 = yi0 + 1
    off = _offset(offset, x)

    def corner(xi, yi, w):
        inb = (xi >= 0) & (xi < width) & (yi >= 0) & (yi < height)
        idx = off + yi.clamp(0, height - 1) * width + xi.clamp(0, width - 1)
        vals = _take_cols(img_flat, idx)  # [..., C, N]
        return vals * (w * inb.to(img_flat.dtype))[..., None, :]

    return (
        corner(xi0, yi0, wx0 * wy0)
        + corner(xi1, yi1, wx1 * wy1)
        + corner(xi0, yi1, wx0 * wy1)
        + corner(xi1, yi0, wx1 * wy0)
    )


def nearest_flat(
    img_flat: torch.Tensor,  # [C, total] or [total]
    x: torch.Tensor,
    y: torch.Tensor,
    width: int,
    height: int,
    offset=0,
) -> torch.Tensor:
    """Zero-padding nearest gather (round half-to-even, as jnp.round),
    used for validity masks -> [..., C, N] or [..., N]."""
    xr = _int_coord(torch.round(x), width)
    yr = _int_coord(torch.round(y), height)
    inb = (xr >= 0) & (xr < width) & (yr >= 0) & (yr < height)
    idx = (
        _offset(offset, x) + yr.clamp(0, height - 1) * width
        + xr.clamp(0, width - 1)
    )
    if img_flat.dim() == 1:
        return img_flat[idx] * inb.to(img_flat.dtype)
    return _take_cols(img_flat, idx) * inb.to(img_flat.dtype)[..., None, :]


def locations_1d_to_2d(loc1d: torch.Tensor, width: int):
    """1D pixel index -> (x, y) float pixel coords."""
    loc = loc1d.to(torch.float32)
    return torch.remainder(loc, float(width)), torch.floor(loc / float(width))


def locations_1d_to_homo(loc1d: torch.Tensor, cam) -> torch.Tensor:
    """1D pixel index -> homogeneous camera coords [..., N, 3]."""
    x2d, y2d = locations_1d_to_2d(loc1d, cam.width)
    return torch.stack(
        [(x2d - cam.cx) / cam.fx, (y2d - cam.cy) / cam.fy, torch.ones_like(x2d)],
        dim=-1,
    )
