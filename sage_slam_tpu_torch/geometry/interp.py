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


def pack_quads_level(rows: torch.Tensor, width: int) -> torch.Tensor:
    """Pack ONE row-major level image [..., M, C] (M = width*height) into
    quad rows [..., M + width + 1, 4C] holding all four bilinear corners:

      out[q] = (rows[q-w-1], rows[q-w], rows[q-1], rows[q]),  w = width

    so the gather at ``q = (w+1) + y0*w + x0`` yields the corners
    (x0,y0), (x1,y0), (x0,y1), (x1,y1) in slots 0..3. Out-of-image slots
    read zero padding or a neighboring row, but only for corners whose
    bounds weight is exactly zero."""
    m, c = rows.shape[-2:]
    z = torch.zeros(
        (*rows.shape[:-2], width + 1, c), dtype=rows.dtype, device=rows.device
    )
    ext = torch.cat([z, rows, z], dim=-2)  # ext[j] = rows[j-w-1]
    n = m + width + 1
    return torch.cat(
        [
            ext[..., 0:n, :],
            ext[..., 1 : n + 1, :],
            ext[..., width : n + width, :],
            ext[..., width + 1 : n + width + 1, :],
        ],
        dim=-1,
    )


def _quad_anchor(x, y, width, height, offset):
    """Quad-table row index and the four bounds-masked corner weights."""
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx0 = (x0 + 1.0) - x
    wy0 = (y0 + 1.0) - y
    wx1 = 1.0 - wx0
    wy1 = 1.0 - wy0
    xi0 = _int_coord(x0, width)
    yi0 = _int_coord(y0, height)
    dt = x.dtype
    bx0 = ((xi0 >= 0) & (xi0 < width)).to(dt)
    bx1 = ((xi0 + 1 >= 0) & (xi0 + 1 < width)).to(dt)
    by0 = ((yi0 >= 0) & (yi0 < height)).to(dt)
    by1 = ((yi0 + 1 >= 0) & (yi0 + 1 < height)).to(dt)
    # clip to [-1, dim-1] so q stays inside this level's segment; clipped
    # coordinates always carry zero bounds weight (computed pre-clip)
    xc = xi0.clamp(-1, width - 1)
    yc = yi0.clamp(-1, height - 1)
    q = _offset(offset, x) + (width + 1) + yc * width + xc
    return q, (
        wx0 * wy0 * bx0 * by0,
        wx1 * wy0 * bx1 * by0,
        wx0 * wy1 * bx0 * by1,
        wx1 * wy1 * bx1 * by1,
    )


def bilinear_quad(
    packed: torch.Tensor,  # [total_q, 4C] from pack_quads_level
    x: torch.Tensor,
    y: torch.Tensor,
    width: int,
    height: int,
    offset=0,
) -> torch.Tensor:
    """Zero-padding bilinear gather from a quad-packed level -> [..., N, C]
    (same semantics as bilinear_flat, one gather per point)."""
    c = packed.shape[-1] // 4
    q, (w00, w10, w01, w11) = _quad_anchor(x, y, width, height, offset)
    rowv = packed[q]  # [..., N, 4C]
    return (
        rowv[..., :c] * w00[..., None]
        + rowv[..., c : 2 * c] * w10[..., None]
        + rowv[..., 2 * c : 3 * c] * w01[..., None]
        + rowv[..., 3 * c :] * w11[..., None]
    )


def quad_gather_cols(
    packedT: torch.Tensor,  # [4*cw, total_q] TRANSPOSED quad table
    x: torch.Tensor,
    y: torch.Tensor,
    width: int,
    height: int,
    offset=0,
):
    """One quad-column gather from a transposed quad table ->
    (rowv [..., 4*cw, N], (w00, w10, w01, w11) each [..., N]); the weights
    carry the per-corner zero padding."""
    q, weights = _quad_anchor(x, y, width, height, offset)
    return _take_cols(packedT, q), weights


def combine_quad_cm(rowv: torch.Tensor, weights, c: int, cw: int | None = None):
    """Channel-major weighted corner combine -> [..., c, N]."""
    if cw is None:
        cw = c
    w00, w10, w01, w11 = (w[..., None, :] for w in weights)
    return (
        rowv[..., 0 * cw : 0 * cw + c, :] * w00
        + rowv[..., 1 * cw : 1 * cw + c, :] * w10
        + rowv[..., 2 * cw : 2 * cw + c, :] * w01
        + rowv[..., 3 * cw : 3 * cw + c, :] * w11
    )


def quad_bilinear_select_cm(rowv: torch.Tensor, weights, col: int, cw: int):
    """Bilinear value of row ``col`` of each corner block -> [..., N]
    (the soft, continuous mask gate)."""
    w00, w10, w01, w11 = weights
    return (
        rowv[..., 0 * cw + col, :] * w00
        + rowv[..., 1 * cw + col, :] * w10
        + rowv[..., 2 * cw + col, :] * w01
        + rowv[..., 3 * cw + col, :] * w11
    )


def quad_nearest_select_cm(
    rowv: torch.Tensor,  # [..., 4*cw, N]
    x: torch.Tensor,
    y: torch.Tensor,
    width: int,
    height: int,
    col: int,
    cw: int,
) -> torch.Tensor:
    """Nearest-neighbor value of row ``col`` from already-gathered quad
    columns -> [..., N]. Rounding is half-up (frac >= 0.5), as in the JAX
    function; nearest_flat rounds half-to-even."""
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    ex = (x - x0f) >= 0.5
    ey = (y - y0f) >= 0.5
    xr = _int_coord(x0f, width) + ex.long()
    yr = _int_coord(y0f, height) + ey.long()
    inb = (xr >= 0) & (xr < width) & (yr >= 0) & (yr < height)
    m00 = rowv[..., 0 * cw + col, :]
    m10 = rowv[..., 1 * cw + col, :]
    m01 = rowv[..., 2 * cw + col, :]
    m11 = rowv[..., 3 * cw + col, :]
    mx0 = torch.where(ey, m01, m00)
    mx1 = torch.where(ey, m11, m10)
    val = torch.where(ex, mx1, mx0)
    return val * inb.to(rowv.dtype)


def dense_bilinear_cm(
    rows_cm: torch.Tensor,  # [..., C, H*W] one level image, channel-major
    x: torch.Tensor,  # [..., N] level coords
    y: torch.Tensor,
    width: int,
    height: int,
) -> torch.Tensor:
    """Gather-free bilinear sampling of a SMALL level image -> [..., C, N]:
    separable hat weights ``relu(1-|x-px|) * relu(1-|y-py|)`` contracted
    against the image rows (float32 matmul)."""
    c = rows_cm.shape[-2]
    dt = rows_cm.dtype
    px = torch.arange(width, dtype=dt, device=rows_cm.device)
    py = torch.arange(height, dtype=dt, device=rows_cm.device)
    wx = torch.clamp(1.0 - torch.abs(x[..., :, None] - px), min=0.0)  # [..., N, W]
    wy = torch.clamp(1.0 - torch.abs(y[..., :, None] - py), min=0.0)  # [..., N, H]
    lead = rows_cm.shape[:-2]
    b = rows_cm.reshape(*lead, c * height, width) @ wx.transpose(-1, -2)
    b = b.reshape(*lead, c, height, -1)  # [..., C, H, N]
    return torch.sum(b * wy.transpose(-1, -2)[..., None, :, :], dim=-2)


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


def valid_locations(mask_flat: torch.Tensor, width: int, fx, fy, cx, cy):
    """Every pixel's homogeneous camera coordinates [HW, 3] and the mask
    as booleans (mask > 0.5); static shapes, no compaction."""
    n = mask_flat.shape[-1]
    loc1d = torch.arange(n, dtype=torch.float32, device=mask_flat.device)
    x2d = torch.remainder(loc1d, float(width))
    y2d = torch.floor(loc1d / float(width))
    homo = torch.stack([(x2d - cx) / fx, (y2d - cy) / fy, torch.ones_like(x2d)], dim=-1)
    return homo, mask_flat > 0.5


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
