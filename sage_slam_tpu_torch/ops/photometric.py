"""Photometric (feature-metric) factor — residual, Jacobian, Hessian.

Port of sage_slam_tpu/ops/photometric.py, batched over a leading edge axis
``E`` where the JAX package vmaps one edge at a time.

Variable block layout of the 13+CS Hessian:
  [0:6] pose0 tangent, [6:12] pose1 tangent, [12:12+CS] code0, [12+CS] scale0.

Semantics (as in the JAX package):
* residual r = gate * (f0 - f1) per channel, gate = (z > eps) * mask,
* J stored is d(f1)/d(params), so the GN step is AtA^-1 Atb,
* inlier normalization uses the level-0 gate only,
* zero-inlier penalty: error = 10 * sum(level weights), AtA = Atb = 0,
* J^T W J uses the per-point 2x2 gradient-Gram factorization; the reduce
  is ops/photo_reduce.photo_reduce (a CUDA kernel on the card).

Tables: the target frame is sampled from channel-major quad-packed tables
(``packed_fg [4*(3C+1), K*Tq]``, ``packed_feat [4*(C+1), K*Tq]``, the
full-res validity mask folded in as the last row of each corner block) and,
for the coarse levels of at most DENSE_MAX_PIXELS pixels, from dense
per-frame tables sampled by hat-weight matmuls. FrameTables holds them,
with the source decode tables and the prep kernel's rows, for every
caller.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import interp
from ..geometry.camera import CameraPyramid
from ..geometry.se3 import SE3
from . import residuals
from .photo_prep import pixel_table
from .photo_reduce import photo_reduce

DENSE_MAX_PIXELS = 512
DENSE_MAX_PIXELS_FEAT = 512


class PhotoShared(NamedTuple):
    """Shared (not per-edge) window tables, flattened over K keyframes of
    HW pixels and T pyramid pixels: bias_flat [K*HW], jac_flat [K*HW, CS],
    feat_pyr [C, K*T], grad_pyr [2, C, K*T], mask_flat [HW], plus the
    window's FrameTables (built inside each factor evaluation when None)."""

    bias_flat: torch.Tensor
    jac_flat: torch.Tensor
    feat_pyr: torch.Tensor
    grad_pyr: torch.Tensor
    mask_flat: torch.Tensor
    tables: FrameTables | None = None


def single_frame_shared(bias_flat, jac_flat, feat_pyr, grad_pyr, mask_flat,
                        cam_pyr: CameraPyramid | None = None) -> PhotoShared:
    """One frame's arrays as a K=1 shared table (training, tests). With
    cam_pyr the sampling tables are built here; without, inside each factor
    evaluation."""
    tables = None if cam_pyr is None else FrameTables.build(feat_pyr, grad_pyr, mask_flat, cam_pyr)
    return PhotoShared(bias_flat, jac_flat, feat_pyr, grad_pyr, mask_flat, tables)


class PhotoKf0(NamedTuple):
    """Per-edge source-keyframe data, leading axis E."""

    loc1d: torch.Tensor  # [E, N] pixel ids (within one frame)
    homo0: torch.Tensor  # [E, N, 3]
    src_feats: torch.Tensor  # [E, L, N, C]
    base_hw: torch.Tensor  # [E] kf0_index * HW
    base_pyr: torch.Tensor  # [E] kf0_index * T
    bias_at: torch.Tensor | None = None  # [E, N]
    jac_at: torch.Tensor | None = None  # [E, N, CS]


class PhotoFr1(NamedTuple):
    """Per-edge target-frame handle: base offset into the shared pyramid."""

    base_pyr: torch.Tensor  # [E] fr1_index * T


def dense_levels(cam_pyr: CameraPyramid, max_pixels: int = DENSE_MAX_PIXELS):
    """Suffix of pyramid levels sampled densely (never level 0, which
    carries the folded mask column)."""
    return [
        lvl
        for lvl in range(1, cam_pyr.levels)
        if cam_pyr[lvl].num_pixels <= max_pixels
    ]


def _pack_pyramid_quads(rows: torch.Tensor, cam_pyr: CameraPyramid):
    """Quad-pack [K, T, C] per level segment -> [K*Tq, 4C]."""
    c = rows.shape[-1]
    segs = []
    for lvl, cam in enumerate(cam_pyr.cameras):
        off = cam_pyr.level_offsets[lvl]
        segs.append(
            interp.pack_quads_level(rows[:, off : off + cam.num_pixels], cam.width)
        )
    return torch.cat(segs, dim=1).reshape(-1, 4 * c)


def build_photo_tables(
    feat_pyr: torch.Tensor,  # [C, K*T]
    grad_pyr: torch.Tensor,  # [2, C, K*T]
    mask_flat: torch.Tensor,  # [HW]
    cam_pyr: CameraPyramid,
):
    """Target-sampling tables -> (packed_fg [4*(3C+1), K*Tq],
    packed_feat [4*(C+1), K*Tq], dense_fg, dense_feat), channel-major and
    contiguous."""
    c, m = feat_pyr.shape
    t = cam_pyr.total_pixels
    k = m // t
    featT = feat_pyr.T.reshape(k, t, c)
    gradT = grad_pyr.reshape(2 * c, m).T.reshape(k, t, 2 * c)  # d-major
    rows_fg = torch.cat([featT, gradT], dim=-1)  # [K, T, 3C]
    hw = cam_pyr[0].num_pixels
    mask_col = torch.zeros((k, t, 1), dtype=feat_pyr.dtype, device=feat_pyr.device)
    mask_col[:, :hw, 0] = mask_flat[None, :]
    packed_fg = _pack_pyramid_quads(
        torch.cat([rows_fg, mask_col], dim=-1), cam_pyr
    ).T.contiguous()
    packed_feat = _pack_pyramid_quads(
        torch.cat([featT, mask_col], dim=-1), cam_pyr
    ).T.contiguous()
    dense_fg = []
    dense_feat = []
    for lvl in dense_levels(cam_pyr):
        off = cam_pyr.level_offsets[lvl]
        npx = cam_pyr[lvl].num_pixels
        dense_fg.append(rows_fg[:, off : off + npx].transpose(1, 2).contiguous())
    for lvl in dense_levels(cam_pyr, DENSE_MAX_PIXELS_FEAT):
        off = cam_pyr.level_offsets[lvl]
        npx = cam_pyr[lvl].num_pixels
        dense_feat.append(featT[:, off : off + npx].transpose(1, 2).contiguous())
    return packed_fg, packed_feat, tuple(dense_fg), tuple(dense_feat)


class FrameTables(NamedTuple):
    """The sampling tables derived from K keyframes, and the one owner of
    their format: other modules read the fields or call the methods, and
    never index, slice or reshape a table.

    The packed tables fold the keyframe axis into their columns (keyframe
    k owns columns [k*Tq, (k+1)*Tq)); every other table leads with it. A
    frame of its own (FrameData, a tracker target) holds K=1 tables, a
    keyframe store K = its capacity. bias_at / jac_at, the source decode
    at the sampled pixels, are None without sampled pixels (a tracker
    target); pixel_fg is None for tables converted from the JAX package,
    which has none."""

    packed_fg: torch.Tensor  # [4*(3C+1), K*Tq] quads of features, gradients, mask
    packed_feat: torch.Tensor  # [4*(C+1), K*Tq] quads of features, mask
    dense_fg: tuple  # per dense level: [K, 3C, M_l]
    dense_feat: tuple  # per dense level: [K, C, M_l]
    bias_at: torch.Tensor | None  # [K, N]
    jac_at: torch.Tensor | None  # [K, N, CS]
    pixel_fg: torch.Tensor | None  # [K, T, PW] the prep kernel's rows (photo_prep.pixel_table)

    @staticmethod
    def build(feat_pyr, grad_pyr, mask_flat, cam_pyr: CameraPyramid, loc1d=None,
              bias_flat=None, jac_flat=None) -> FrameTables:
        """The tables of K >= 1 frames from their pyramids (feat_pyr [C, T],
        [C, K, T] or [C, K*T]; grad_pyr likewise with a leading 2) and the
        mask [HW]; with loc1d ([N] or [K, N]) the decode tables too, from
        bias_flat ([HW] or [K, HW]) and jac_flat ([HW, CS] or [K, HW, CS])."""
        c = feat_pyr.shape[0]
        feat, grad = feat_pyr.reshape(c, -1), grad_pyr.reshape(2, c, -1)
        bias_at = jac_at = None
        if loc1d is not None:
            k = feat.shape[1] // cam_pyr.total_pixels
            loc = loc1d.long().reshape(k, -1)
            bias_at = bias_flat.reshape(k, -1).take_along_dim(loc, 1)
            jac_at = jac_flat.reshape(k, -1, jac_flat.shape[-1]).take_along_dim(loc[..., None], 1)
        return FrameTables(
            *build_photo_tables(feat, grad, mask_flat, cam_pyr), bias_at, jac_at,
            pixel_table(feat, grad, mask_flat, cam_pyr),
        )

    @staticmethod
    def zeros(capacity: int, like: FrameTables, device=None) -> FrameTables:
        """Zero tables of ``capacity`` keyframes, shaped and typed as
        ``like``'s rows (a store's, allocated at its first write)."""

        def alloc(t, axis):
            shape = list(t.shape)
            shape[axis] = capacity
            return torch.zeros(shape, dtype=t.dtype, device=device)

        return like.map(alloc)

    @property
    def num_kf(self) -> int:
        for t in (self.pixel_fg, self.bias_at, *self.dense_fg, *self.dense_feat):
            if t is not None:
                return t.shape[0]
        raise ValueError("frame tables: no table has a keyframe axis")

    def map(self, fn) -> FrameTables:
        """The tables with ``fn(table, kf_axis)`` applied to each: the packed
        tables given as [cw, K, Tq] (kf_axis 1) and folded back from what
        fn returns, the others as they are (kf_axis 0)."""
        k = self.num_kf

        def packed(t):
            return fn(t.reshape(t.shape[0], k, -1), 1).reshape(t.shape[0], -1)

        def opt(t):
            return None if t is None else fn(t, 0)

        return FrameTables(
            packed(self.packed_fg), packed(self.packed_feat),
            tuple(fn(d, 0) for d in self.dense_fg), tuple(fn(d, 0) for d in self.dense_feat),
            opt(self.bias_at), opt(self.jac_at), opt(self.pixel_fg),
        )

    def leaves(self) -> list:
        """[(table, kf_axis)] in map's order, each as map gives it to fn."""
        out = []
        self.map(lambda t, axis: out.append((t, axis)) or t)
        return out

    def rows(self, sel) -> FrameTables:
        """The tables of keyframes ``sel``: a slice, an index tensor (one
        gather a table) or one id (K=1 views)."""
        if not isinstance(sel, (slice, torch.Tensor)):
            sel = slice(sel, sel + 1)
        return self.map(lambda t, axis: t[:, sel] if axis else t[sel])

    def write(self, i: int, one: FrameTables) -> None:
        """Write one frame's tables (K=1) into keyframe row i, in place.
        The pixel rows come with every frame's tables or with none."""
        if (one.pixel_fg is None) != (self.pixel_fg is None):
            raise ValueError("frame tables: pixel rows come with every frame's tables or with none")
        for (row, axis), (src, _) in zip(self.leaves(), one.leaves()):
            row.select(axis, i).copy_(src.select(axis, 0))

    def source_at(self, idx: torch.Tensor):
        """The decode tables of keyframes ``idx`` [E] -> (bias_at [E, N],
        jac_at [E, N, CS]), or (None, None) without them."""
        if self.bias_at is None:
            return None, None
        return self.bias_at[idx], self.jac_at[idx]

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t, _ in self.leaves())


def _tables(shared: PhotoShared, cam_pyr: CameraPyramid) -> FrameTables:
    """The window's sampling tables, built here when the shared ones are
    unset."""
    if shared.tables is not None:
        return shared.tables
    return FrameTables.build(shared.feat_pyr, shared.grad_pyr, shared.mask_flat, cam_pyr)


def _target_samples_cm(
    mask_flat: torch.Tensor,
    cam_pyr: CameraPyramid,
    u1: torch.Tensor,  # [E, N]
    v1: torch.Tensor,
    base_pyr: torch.Tensor,  # [E]
    packedT: torch.Tensor,
    dense: tuple,
    c_out: int,
    soft: bool = False,
):
    """Sample the target frame at the warped full-res coords for every
    pyramid level -> (list of [E, c_out, N] per level, within [E, N]).
    Level 0 comes from one quad gather that also yields the folded mask,
    the dense coarse levels from hat-weight matmuls, the rest from one
    quad gather each."""
    cam0 = cam_pyr[0]
    cw = packedT.shape[0] // 4
    has_mask = cw == c_out + 1
    nd = len(dense)
    dense_start = cam_pyr.levels - nd if nd else cam_pyr.levels
    frame = torch.div(base_pyr, cam_pyr.total_pixels, rounding_mode="floor")
    qbase = frame * cam_pyr.total_quad_rows
    out = []
    within = None
    for lvl in range(cam_pyr.levels):
        cam_l = cam_pyr[lvl]
        ul, vl = interp.level_coords(u1, v1, cam_l.fx / cam0.fx, cam_l.fy / cam0.fy)
        if lvl >= dense_start:
            rows_cm = dense[lvl - dense_start][frame]  # [E, c_out, M_l]
            out.append(
                interp.dense_bilinear_cm(rows_cm, ul, vl, cam_l.width, cam_l.height)
            )
            continue
        off = qbase + cam_pyr.quad_level_offsets[lvl]
        rowv, wts = interp.quad_gather_cols(
            packedT, ul, vl, cam_l.width, cam_l.height, off
        )
        out.append(interp.combine_quad_cm(rowv, wts, c_out, cw))
        if lvl == 0 and has_mask:
            if soft:
                within = interp.quad_bilinear_select_cm(rowv, wts, c_out, cw)
            else:
                within = interp.quad_nearest_select_cm(
                    rowv, ul, vl, cam_l.width, cam_l.height, c_out, cw
                )
    if within is None:
        if soft:
            within = interp.bilinear_flat(
                mask_flat[None], u1, v1, cam0.width, cam0.height
            )[..., 0, :]
        else:
            within = interp.nearest_flat(mask_flat, u1, v1, cam0.width, cam0.height)
    return out, within


def sample_source_features(feat_pyr, loc1d, cam_pyr: CameraPyramid):
    """A single frame's own features [C, T] at its photometric points for
    every level -> [L, N, C]."""
    cam0 = cam_pyr[0]
    x0, y0 = interp.locations_1d_to_2d(loc1d, cam0.width)
    out = []
    for lvl in range(cam_pyr.levels):
        cam_l = cam_pyr[lvl]
        ul, vl = interp.level_coords(x0, y0, cam_l.fx / cam0.fx, cam_l.fy / cam0.fy)
        f = interp.bilinear_flat(
            feat_pyr, ul, vl, cam_l.width, cam_l.height, cam_pyr.level_offsets[lvl]
        )
        out.append(f.T)
    return torch.stack(out, dim=0)


def _warp_project_cm(
    p0: SE3,  # [E] poses
    p1: SE3,
    code0: torch.Tensor,  # [E, CS]
    scale0: torch.Tensor,  # [E]
    kf0: PhotoKf0,
    shared: PhotoShared,
    cam0,
    eps: float,
):
    """Channel-major per-point geometry shared by the photometric and
    geometric factors -> (depth0 [E, N], jac_cm [E, CS, N], homo_cm
    [E, 3, N], rh [E, 3, N], x1 [E, 3, N], pos [E, N], u1 [E, N], v1)."""
    rot10, t10 = residuals.relative_pose_tensors(p0, p1)
    homo_cm = kf0.homo0.transpose(-1, -2)  # [E, 3, N]
    if kf0.bias_at is not None:
        bias_at, jac_at = kf0.bias_at, kf0.jac_at
    else:
        loc = kf0.base_hw.long()[:, None] + kf0.loc1d.long()
        bias_at = shared.bias_flat[loc]
        jac_at = shared.jac_flat[loc]
    jac_cm = jac_at.transpose(-1, -2)  # [E, CS, N]
    depth0 = scale0[:, None] * (bias_at + (code0[:, None, :] @ jac_cm)[:, 0])
    rh = rot10 @ homo_cm  # [E, 3, N]
    x1 = depth0[:, None] * rh + t10[..., None]
    front = x1[:, 2] > eps
    pos = front.to(depth0.dtype)
    # gated-out points must not divide by ~0 z (0-gate times inf = NaN)
    z = torch.where(front, x1[:, 2], torch.ones_like(x1[:, 2]))
    x1 = torch.cat([x1[:, :2], z[:, None]], dim=1)
    u1 = x1[:, 0] / x1[:, 2] * cam0.fx + cam0.cx
    v1 = x1[:, 1] / x1[:, 2] * cam0.fy + cam0.cy
    return depth0, jac_cm, homo_cm, rh, x1, pos, u1, v1


def photometric_error(
    p0: SE3,
    p1: SE3,
    code0: torch.Tensor,
    scale0: torch.Tensor,
    kf0: PhotoKf0,
    fr1: PhotoFr1,
    shared: PhotoShared,
    cam_pyr: CameraPyramid,
    weights,
    eps: float,
    soft: bool = False,
):
    """Error-only path -> (error [E], n_inliers [E]). The residual is
    r = gate * d, so the error and count use gate^2."""
    cam0 = cam_pyr[0]
    _, _, _, _, _, pos, u1, v1 = _warp_project_cm(
        p0, p1, code0, scale0, kf0, shared, cam0, eps
    )
    c = shared.feat_pyr.shape[0]
    tables = _tables(shared, cam_pyr)
    f1s, within = _target_samples_cm(
        shared.mask_flat, cam_pyr, u1, v1, fr1.base_pyr, tables.packed_feat,
        tables.dense_feat, c, soft=soft,
    )
    g2 = (pos * within) ** 2
    err_total = torch.zeros_like(g2[:, 0])
    for lvl in range(cam_pyr.levels):
        f0 = kf0.src_feats[:, lvl].transpose(-1, -2)  # [E, C, N]
        err_pt = g2 * torch.sum((f0 - f1s[lvl]) ** 2, dim=1)
        err_total = err_total + weights[lvl] * torch.sum(err_pt, dim=-1)
    n_inl = torch.sum(g2, dim=-1)
    w_sum = _weight_sum(weights, g2)
    error = torch.where(
        n_inl > 0, err_total / torch.clamp(n_inl, min=1.0), w_sum * 10.0
    )
    return error, n_inl


def _weight_sum(weights, like: torch.Tensor) -> torch.Tensor:
    """Sum of the level weights: a config tuple of floats, or a tensor,
    which keeps its graph (learnt weights)."""
    if isinstance(weights, torch.Tensor):
        return torch.sum(weights.to(like.dtype))
    return torch.sum(torch.tensor(weights, dtype=like.dtype, device=like.device))


def level_ratios(cam_pyr: CameraPyramid):
    """Per-level focal ratios [(rx_l, ry_l)] relative to level 0."""
    cam0 = cam_pyr[0]
    return tuple(
        (cam_pyr[lvl].fx / cam0.fx, cam_pyr[lvl].fy / cam0.fy)
        for lvl in range(cam_pyr.levels)
    )


def photo_normalize(ata, atb, err_total, n_inl, weights):
    """Inlier normalization + zero-inlier penalty, batched over E."""
    w_sum = _weight_sum(weights, ata)
    has_inl = n_inl > 0
    inv = torch.where(
        has_inl, 1.0 / torch.clamp(n_inl, min=1.0), torch.zeros_like(n_inl)
    )
    error = torch.where(has_inl, err_total * inv, w_sum * 10.0)
    return ata * inv[:, None, None], atb * inv[:, None], error, n_inl


def photo_prep(
    p0: SE3,
    p1: SE3,
    code0: torch.Tensor,
    scale0: torch.Tensor,
    kf0: PhotoKf0,
    fr1: PhotoFr1,
    shared: PhotoShared,
    cam_pyr: CameraPyramid,
    eps: float,
    soft: bool = False,
):
    """Warp + sample + K-row construction for E photometric edges ->
    contiguous (fgs [E, L, 3C, N], f0_cm [E, L, C, N], gate [E, N],
    kx [E, 13+CS, N], ky [E, 13+CS, N]), the reduce's inputs. The plain
    version of ops/photo_prep's kernel, which ba.linearize runs in its
    place on CUDA tensors without a graph."""
    cam0 = cam_pyr[0]
    depth0, jac_cm, homo_cm, rh, x1, pos, u1, v1 = _warp_project_cm(
        p0, p1, code0, scale0, kf0, shared, cam0, eps
    )
    c = shared.feat_pyr.shape[0]
    tables = _tables(shared, cam_pyr)
    fgs, within = _target_samples_cm(
        shared.mask_flat, cam_pyr, u1, v1, fr1.base_pyr, tables.packed_fg,
        tables.dense_fg, 3 * c, soft=soft,
    )
    gate = pos * within  # [E, N]

    # geometry K-rows [E, 29, N] from [E, N] scalars
    inv_z = 1.0 / x1[:, 2]
    xz = x1[:, 0] * inv_z
    yz = x1[:, 1] * inv_z
    fxz = cam0.fx * inv_z
    fyz = cam0.fy * inv_z
    # world points and jac = R1^T [I | -hat(Xw)]
    xw = depth0[:, None] * (p0.rot @ homo_cm) + p0.trans[..., None]  # [E, 3, N]
    a = p1.rot.transpose(-1, -2)  # R1^T [E, 3, 3]
    zr = torch.zeros_like(xw[:, 0])
    nh0 = torch.stack([zr, -xw[:, 2], xw[:, 1]], dim=1)  # -hat(Xw) columns
    nh1 = torch.stack([xw[:, 2], zr, -xw[:, 0]], dim=1)
    nh2 = torch.stack([-xw[:, 1], xw[:, 0], zr], dim=1)
    kxp = [fxz * (a[:, 0, kk, None] - xz * a[:, 2, kk, None]) for kk in range(3)]
    kyp = [fyz * (a[:, 1, kk, None] - yz * a[:, 2, kk, None]) for kk in range(3)]
    for nh in (nh0, nh1, nh2):
        jr = a @ nh  # [E, 3, N]
        kxp.append(fxz * (jr[:, 0] - xz * jr[:, 2]))
        kyp.append(fyz * (jr[:, 1] - yz * jr[:, 2]))
    kx_pose = torch.stack(kxp, dim=1)  # [E, 6, N]
    ky_pose = torch.stack(kyp, dim=1)
    # depth / code / scale columns
    dx = cam0.fx * (rh[:, 0] * inv_z - x1[:, 0] * rh[:, 2] * inv_z * inv_z)
    dy = cam0.fy * (rh[:, 1] * inv_z - x1[:, 1] * rh[:, 2] * inv_z * inv_z)
    s0 = scale0[:, None]
    kx = torch.cat(
        [kx_pose, -kx_pose, (dx * s0)[:, None] * jac_cm, (dx * (depth0 / s0))[:, None]],
        dim=1,
    )
    ky = torch.cat(
        [ky_pose, -ky_pose, (dy * s0)[:, None] * jac_cm, (dy * (depth0 / s0))[:, None]],
        dim=1,
    )
    f0_cm = kf0.src_feats.transpose(-1, -2).contiguous()  # [E, L, C, N]
    return torch.stack(fgs, dim=1), f0_cm, gate.contiguous(), kx, ky


def photometric_jac_error(
    p0: SE3,
    p1: SE3,
    code0: torch.Tensor,
    scale0: torch.Tensor,
    kf0: PhotoKf0,
    fr1: PhotoFr1,
    shared: PhotoShared,
    cam_pyr: CameraPyramid,
    weights,
    eps: float,
    soft: bool = False,
    host_weights=None,
):
    """Linearization path -> (AtA [E, 13+CS, 13+CS], Atb [E, 13+CS],
    error [E], n_inliers [E]):
      AtA = Kx^T (gxx Kx + gxy Ky) + Ky^T (gxy Kx + gyy Ky)
    with gxx/gxy/gyy the level-weighted per-point gradient Gram. Learnt
    weights (a tensor [L]) stay in the graph; ``host_weights`` gives the
    kernel their float values without a read from the card."""
    fgs, f0_cm, gate, kx, ky = photo_prep(
        p0, p1, code0, scale0, kf0, fr1, shared, cam_pyr, eps, soft=soft
    )
    ata, atb, err_total, n_inl = photo_reduce(
        fgs, f0_cm, gate, kx, ky, weights, level_ratios(cam_pyr), host_weights
    )
    return photo_normalize(ata, atb, err_total, n_inl, weights)
