"""Geometric (depth-consistency) factor — Cauchy-robustified.

Port of sage_slam_tpu/ops/geometric.py, batched over a leading edge axis E.

Residual per sampled point of kf0 warped into kf1:
  r = within_mask * (d1_sampled - z1),
with d1_sampled kf1's scaled decoded depth bilinearly sampled at the warped
pixel. Robust weights ``sqrt_w = within * rsqrt(r_raw^2 + loss_param)``
gated by z1 > eps; the error is ``log(1 + (within*r)^2 / loss_param)``.
Rows store d(z1 - d1)/d(params), so the GN step is AtA^-1 Atb.

Hessian block layout (dim 14+2CS):
  [0:6] pose0, [6:12] pose1, [12:12+CS] code0, [12+CS:12+2CS] code1,
  [12+2CS] scale0, [13+2CS] scale1.

Frame-1 values come from the quad-packed tables of build_frame1_tables,
rebuilt once per linearization (they depend on code and scale); without
them (training) each edge decodes its frame 1 from the flat tables. The
per-edge product ``rows @ rows^T`` is a plain batched matmul.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import interp
from ..geometry.camera import PinholeCamera
from ..geometry.se3 import SE3
from .photometric import _warp_project_cm
from .pyramid import spatial_grad


class GeoShared(NamedTuple):
    """Shared flat depth tables: bias_flat [K*HW], jac_flat [K*HW, CS],
    mask_flat [HW], and the frame-1 quad tables of build_frame1_tables."""

    bias_flat: torch.Tensor
    jac_flat: torch.Tensor
    mask_flat: torch.Tensor
    packed_full: torch.Tensor | None = None  # [4*(3+CS+1), K*R], R = HW+w+1
    packed_dpt: torch.Tensor | None = None  # [4*2, K*R]


class GeoKf0(NamedTuple):
    loc1d: torch.Tensor  # [E, N]
    homo0: torch.Tensor  # [E, N, 3]
    base_hw: torch.Tensor  # [E] kf0_index * HW
    bias_at: torch.Tensor | None = None  # [E, N]
    jac_at: torch.Tensor | None = None  # [E, N, CS]


class GeoKf1(NamedTuple):
    base_hw: torch.Tensor  # [E] kf1_index * HW


def build_frame1_tables(
    bias: torch.Tensor,  # [K, HW]
    jac: torch.Tensor,  # [K, HW, CS]
    codes: torch.Tensor,  # [K, CS]
    scales: torch.Tensor,  # [K]
    cam: PinholeCamera,
    mask_flat: torch.Tensor | None = None,  # [HW]
    which: str = "both",  # "both" | "full" | "dpt"
):
    """Quad-packed per-keyframe frame-1 tables for the current variables
    -> (packed_full [4*(3+CS[+1]), K*R] holding [scaled depth | scaled
    grad (2) | raw code jacobian [| mask]], packed_dpt [4*(1[+1]), K*R]),
    channel-major and contiguous; ``which`` skips the unused table."""
    k, hw = bias.shape
    h, w = cam.height, cam.width
    unscaled = bias + (jac @ codes[:, :, None])[..., 0]  # [K, HW]
    dpt = scales[:, None] * unscaled
    mask_col = (
        None if mask_flat is None
        else mask_flat[None, :, None].expand(k, hw, 1)
    )
    packed_full = packed_dpt = None
    if which in ("both", "full"):
        grad = spatial_grad(unscaled.reshape(k, h, w))  # [2, K, H, W]
        grad_rows = (scales[None, :, None] * grad.reshape(2, k, hw)).permute(1, 2, 0)
        parts = [dpt[..., None], grad_rows, jac]
        if mask_col is not None:
            parts.append(mask_col)
        rows = torch.cat(parts, dim=-1)
        packed_full = (
            interp.pack_quads_level(rows, w).reshape(k * (hw + w + 1), -1).T.contiguous()
        )
    if which in ("both", "dpt"):
        dpt_rows = dpt[..., None]
        if mask_col is not None:
            dpt_rows = torch.cat([dpt_rows, mask_col], dim=-1)
        packed_dpt = (
            interp.pack_quads_level(dpt_rows, w).reshape(k * (hw + w + 1), -1).T.contiguous()
        )
    return packed_full, packed_dpt


def _quad_base(kf1: GeoKf1, hw: int, w: int):
    """Frame-1 row offset in the quad tables from the pixel offset."""
    return torch.div(kf1.base_hw, hw, rounding_mode="floor") * (hw + w + 1)


def _frame1_samples(shared: GeoShared, kf1: GeoKf1, code1, scale1, u1, v1, h: int, w: int):
    """Frame 1 decoded per edge from the flat tables (the JAX package's
    _decode_frame1 branch): [scaled depth | scaled grad (2) | raw code
    jacobian] bilinearly sampled at (u1, v1) -> [E, 3+CS, N]."""
    hw = h * w
    e = u1.shape[0]
    idx = kf1.base_hw.long()[:, None] + torch.arange(hw, device=u1.device)  # [E, HW]
    bias1 = shared.bias_flat[idx]
    jac1 = shared.jac_flat[idx]  # [E, HW, CS]
    unscaled = bias1 + (jac1 @ code1[:, :, None])[..., 0]
    grad = spatial_grad(unscaled.reshape(e, h, w)).reshape(2, e, hw)
    s1 = scale1[:, None]
    rows1 = torch.cat(
        [(s1 * unscaled)[..., None], (s1[None] * grad).permute(1, 2, 0), jac1], dim=-1
    )  # [E, HW, 3+CS]
    packed = interp.pack_quads_level(rows1, w)  # [E, R, 4(3+CS)]
    r = packed.shape[1]
    base = torch.arange(e, device=u1.device) * r
    return interp.bilinear_quad(
        packed.reshape(e * r, -1), u1, v1, w, h, base
    ).transpose(-1, -2)


def _require(table, name):
    if table is None:
        raise ValueError(
            f"GeoShared.{name} is unset; build it with build_frame1_tables"
        )
    return table


def geometric_jac_error(
    p0: SE3,
    p1: SE3,
    code0: torch.Tensor,  # [E, CS]
    code1: torch.Tensor,
    scale0: torch.Tensor,  # [E]
    scale1: torch.Tensor,
    kf0: GeoKf0,
    kf1: GeoKf1,
    shared: GeoShared,
    cam: PinholeCamera,
    factor_weight: float,
    loss_param: torch.Tensor,  # [E]
    eps: float,
):
    """-> (AtA [E, D, D], Atb [E, D], error [E], n_inliers [E]),
    D = 14+2CS. Without ``shared.packed_full`` each edge decodes its frame
    1 from the flat tables (the training path). ``factor_weight`` may be a
    tensor carrying a graph."""
    cs = shared.jac_flat.shape[-1]
    h, w = cam.height, cam.width
    hw = h * w

    depth0, jac_cm0, homo_cm, rh, x1, pos, u1, v1 = _warp_project_cm(
        p0, p1, code0, scale0, kf0, shared, cam, eps
    )
    if shared.packed_full is not None:
        cw = shared.packed_full.shape[0] // 4
        rowv, wts = interp.quad_gather_cols(
            shared.packed_full, u1, v1, w, h, _quad_base(kf1, hw, w)
        )
        v = interp.combine_quad_cm(rowv, wts, 3 + cs, cw)  # [E, 3+CS, N]
        if cw == 3 + cs + 1:
            within = interp.quad_nearest_select_cm(rowv, u1, v1, w, h, 3 + cs, cw)
        else:
            within = interp.nearest_flat(shared.mask_flat, u1, v1, w, h)
    else:
        v = _frame1_samples(shared, kf1, code1, scale1, u1, v1, h, w)
        within = interp.nearest_flat(shared.mask_flat, u1, v1, w, h)
    d1 = v[:, 0]
    g1x, g1y = v[:, 1], v[:, 2]
    jac1_cm = v[:, 3:]  # [E, CS, N] raw

    lp = loss_param[:, None]
    z1 = x1[:, 2]
    raw = d1 - z1
    err_pt = pos * torch.log1p((within * raw) ** 2 / lp)
    sqrt_w = pos * within * torch.rsqrt(raw**2 + lp)

    inv_z = 1.0 / z1
    xz = x1[:, 0] * inv_z
    yz = x1[:, 1] * inv_z
    fxz = cam.fx * inv_z
    fyz = cam.fy * inv_z
    xw = depth0[:, None] * (p0.rot @ homo_cm) + p0.trans[..., None]  # [E, 3, N]
    a = p1.rot.transpose(-1, -2)  # R1^T
    zr = torch.zeros_like(xw[:, 0])
    nh = (
        torch.stack([zr, -xw[:, 2], xw[:, 1]], dim=1),  # -hat(Xw) columns
        torch.stack([xw[:, 2], zr, -xw[:, 0]], dim=1),
        torch.stack([-xw[:, 1], xw[:, 0], zr], dim=1),
    )
    # d(z1 - d1)/d pose0 col k = jac[2,k] - (g1x kx[k] + g1y ky[k])
    jp0 = []
    for kk in range(3):
        kx_k = fxz * (a[:, 0, kk, None] - xz * a[:, 2, kk, None])
        ky_k = fyz * (a[:, 1, kk, None] - yz * a[:, 2, kk, None])
        jp0.append(a[:, 2, kk, None] - (g1x * kx_k + g1y * ky_k))
    for m in range(3):
        jr = a @ nh[m]  # [E, 3, N]
        kx_k = fxz * (jr[:, 0] - xz * jr[:, 2])
        ky_k = fyz * (jr[:, 1] - yz * jr[:, 2])
        jp0.append(jr[:, 2] - (g1x * kx_k + g1y * ky_k))
    jpose0 = torch.stack(jp0, dim=1)  # [E, 6, N]

    dx = cam.fx * (rh[:, 0] * inv_z - x1[:, 0] * rh[:, 2] * inv_z * inv_z)
    dy = cam.fy * (rh[:, 1] * inv_z - x1[:, 1] * rh[:, 2] * inv_z * inv_z)
    d1_jac_dpt0 = g1x * dx + g1y * dy  # [E, N]
    rh_z = rh[:, 2]
    s0 = scale0[:, None]
    s1 = scale1[:, None]
    rows = torch.cat(
        [
            jpose0,
            -jpose0,
            ((rh_z - d1_jac_dpt0) * s0)[:, None] * jac_cm0,  # code0
            -s1[:, None] * jac1_cm,  # code1
            ((rh_z - d1_jac_dpt0) * depth0 / s0)[:, None],  # scale0
            (-d1 / s1)[:, None],  # scale1
        ],
        dim=1,
    )  # [E, D, N]
    rows = rows * sqrt_w[:, None]
    diff = sqrt_w * raw

    n_inl = torch.sum(pos * within, dim=-1)
    has = n_inl > 0
    inv = torch.where(
        has, factor_weight / torch.clamp(n_inl, min=1.0), torch.zeros_like(n_inl)
    )
    ata = inv[:, None, None] * (rows @ rows.transpose(-1, -2))
    atb = inv[:, None] * (rows @ diff[..., None])[..., 0]
    error = torch.where(has, inv * torch.sum(err_pt, dim=-1), factor_weight * 10.0)
    return ata, atb, error, n_inl


def geometric_error(
    p0: SE3,
    p1: SE3,
    code0: torch.Tensor,
    code1: torch.Tensor,
    scale0: torch.Tensor,
    scale1: torch.Tensor,
    kf0: GeoKf0,
    kf1: GeoKf1,
    shared: GeoShared,
    cam: PinholeCamera,
    factor_weight: float,
    loss_param: torch.Tensor,
    eps: float,
):
    """Error-only path -> (error [E], n_inliers [E])."""
    packed_dpt = _require(shared.packed_dpt, "packed_dpt")
    h, w = cam.height, cam.width
    hw = h * w
    _, _, _, _, x1, pos, u1, v1 = _warp_project_cm(
        p0, p1, code0, scale0, kf0, shared, cam, eps
    )
    cw = packed_dpt.shape[0] // 4
    rowv, wts = interp.quad_gather_cols(
        packed_dpt, u1, v1, w, h, _quad_base(kf1, hw, w)
    )
    d1 = interp.combine_quad_cm(rowv, wts, 1, cw)[:, 0]
    if cw == 2:
        within = interp.quad_nearest_select_cm(rowv, u1, v1, w, h, 1, cw)
    else:
        within = interp.nearest_flat(shared.mask_flat, u1, v1, w, h)
    raw = d1 - x1[:, 2]
    err_pt = pos * torch.log1p((within * raw) ** 2 / loss_param[:, None])
    n_inl = torch.sum(pos * within, dim=-1)
    error = torch.where(
        n_inl > 0,
        factor_weight * torch.sum(err_pt, dim=-1) / torch.clamp(n_inl, min=1.0),
        factor_weight * 10.0,
    )
    return error, n_inl
