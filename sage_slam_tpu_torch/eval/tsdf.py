"""TSDF volume fusion, mesh extraction and fly-through (port of
sage_slam_tpu/eval/tsdf.py).

Keyframe depth maps are fused into a truncated signed distance volume with
plain torch ops on the volume's device (each voxel projected into the
keyframe, its depth pixel sampled, the truncated SDF averaged). The zero
isosurface is extracted on the host with vectorised marching tetrahedra
(:func:`marching_tetrahedra`, numpy, the port's own copy) and written as a
triangle-mesh PLY (:func:`save_ply`); :func:`fly_through` renders shaded
frames along an interpolated camera path over the mesh.

``TSDFVolume.create`` puts the volume on the card unless the caller passes
``device="cpu"`` (device.resolve_device).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..geometry import se3 as se3m
from ..geometry.camera import PinholeCamera
from ..geometry.se3 import SE3


class TSDFVolume(NamedTuple):
    tsdf: torch.Tensor  # [X, Y, Z] in [-1, 1]
    weight: torch.Tensor  # [X, Y, Z]
    origin: torch.Tensor  # [3]
    voxel_size: float
    trunc: float

    @staticmethod
    def create(origin, dims, voxel_size, trunc_factor: float = 5.0, device=None) -> "TSDFVolume":
        dev = resolve_device(device)
        dims = tuple(int(d) for d in dims)
        return TSDFVolume(
            tsdf=torch.ones(dims, device=dev),
            weight=torch.zeros(dims, device=dev),
            origin=torch.as_tensor(np.asarray(origin, np.float32), device=dev),
            voxel_size=float(voxel_size),
            trunc=float(voxel_size * trunc_factor),
        )


def _projection(vol: TSDFVolume, pose_wc: SE3, cam: PinholeCamera, dtype=torch.float32):
    """Each voxel in the camera, computed in ``dtype`` on the volume's
    device: (z, u, v) [X, Y, Z], pixel coordinates before rounding."""
    dev = vol.tsdf.device
    axes = [torch.arange(n, device=dev) for n in vol.tsdf.shape]
    grid = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)
    world = grid.to(dtype) * vol.voxel_size + vol.origin.to(dtype)
    rot_cw = pose_wc.rot.to(dev, dtype).transpose(-1, -2)
    pts_c = (world - pose_wc.trans.to(dev, dtype)) @ rot_cw.T
    z = pts_c[..., 2]
    u = pts_c[..., 0] / torch.clamp(z, min=1e-6) * cam.fx + cam.cx
    v = pts_c[..., 1] / torch.clamp(z, min=1e-6) * cam.fy + cam.cy
    return z, u, v


def integrate(
    vol: TSDFVolume,
    depth,  # [H, W]
    mask,  # [H, W]
    pose_wc: SE3,  # world-from-camera
    cam: PinholeCamera,
    max_weight: float = 64.0,
) -> TSDFVolume:
    """Fuse one keyframe depth map into a new volume (the running average
    of the truncated SDF; voxels projecting outside the image, outside the
    mask or more than ``trunc`` behind the surface are left as they were)."""
    dev = vol.tsdf.device
    depth = torch.as_tensor(depth, dtype=torch.float32, device=dev)
    mask = torch.as_tensor(mask, dtype=torch.float32, device=dev)
    z, u, v = _projection(vol, pose_wc, cam)
    # round half to even, as jnp.round
    ui = torch.round(u).to(torch.int64)
    vi = torch.round(v).to(torch.int64)
    inb = (z > 1e-6) & (ui >= 0) & (ui < cam.width) & (vi >= 0) & (vi < cam.height)
    ui_c = torch.clamp(ui, 0, cam.width - 1)
    vi_c = torch.clamp(vi, 0, cam.height - 1)
    d = depth[vi_c, ui_c]
    m = mask[vi_c, ui_c]
    valid = inb & (m > 0.5) & (d > 1e-6)

    sdf = d - z
    valid = valid & (sdf > -vol.trunc)
    tsdf_new = torch.clamp(sdf / vol.trunc, -1.0, 1.0)

    w_old = vol.weight
    w_new = valid.to(torch.float32)
    w_total = w_old + w_new
    fused = torch.where(
        w_total > 0,
        (vol.tsdf * w_old + tsdf_new * w_new) / torch.clamp(w_total, min=1e-8),
        vol.tsdf,
    )
    return vol._replace(tsdf=fused, weight=torch.clamp(w_total, max=max_weight))


def near_rounding_boundary(vol: TSDFVolume, depth, pose_wc: SE3, cam: PinholeCamera,
                           px_margin: float = 1e-3, sdf_margin: float = 1e-5) -> np.ndarray:
    """Voxels [X, Y, Z] (bool) whose integrate() decision float32 roundoff
    may flip: the projection lies within ``px_margin`` pixels of a rounding
    boundary (a half pixel), or the SDF within ``sdf_margin`` of the
    truncation limit. Computed in float64 on the volume's device, to tell
    where two float32 volumes may rightly pick different pixels."""
    z, u, v = _projection(vol, pose_wc, cam, torch.float64)
    near = ((u - torch.floor(u) - 0.5).abs() < px_margin) | ((v - torch.floor(v) - 0.5).abs() < px_margin)
    depth = torch.as_tensor(depth).to(vol.tsdf.device, torch.float64)
    ui = torch.round(u).long().clamp(0, cam.width - 1)
    vi = torch.round(v).long().clamp(0, cam.height - 1)
    near |= (depth[vi, ui] - z + vol.trunc).abs() < sdf_margin
    return near.cpu().numpy()


def extract_points(vol: TSDFVolume, threshold: float = 0.2) -> np.ndarray:
    """Surface point cloud: voxels with |tsdf| < threshold and weight
    (host numpy)."""
    tsdf = vol.tsdf.cpu().numpy()
    w = vol.weight.cpu().numpy()
    sel = (np.abs(tsdf) < threshold) & (w > 0)
    idx = np.argwhere(sel)
    return idx * vol.voxel_size + vol.origin.cpu().numpy()


# cube corners, bit layout chosen so the 0-6 main diagonal exists in
# every tetrahedron of the classic 6-tet decomposition
_CORNERS = np.array(
    [
        (0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
        (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1),
    ],
    np.int64,
)
_TETS = np.array(
    [
        (0, 5, 1, 6), (0, 1, 2, 6), (0, 2, 3, 6),
        (0, 3, 7, 6), (0, 7, 4, 6), (0, 4, 5, 6),
    ],
    np.int64,
)
# per-tet triangulation: case bitmask (bit i set = corner i inside) ->
# triangles, each vertex an edge (corner pair) to interpolate on
_TET_TRIS = {
    0b0001: [((0, 1), (0, 2), (0, 3))],
    0b0010: [((1, 0), (1, 3), (1, 2))],
    0b0100: [((2, 0), (2, 1), (2, 3))],
    0b1000: [((3, 0), (3, 2), (3, 1))],
    0b0011: [((0, 2), (0, 3), (1, 3)), ((0, 2), (1, 3), (1, 2))],
    0b0101: [((0, 1), (2, 1), (2, 3)), ((0, 1), (2, 3), (0, 3))],
    0b1001: [((0, 1), (0, 2), (3, 2)), ((0, 1), (3, 2), (3, 1))],
    0b0110: [((1, 0), (2, 0), (2, 3)), ((1, 0), (2, 3), (1, 3))],
    0b1010: [((1, 0), (1, 2), (3, 2)), ((1, 0), (3, 2), (3, 0))],
    0b1100: [((2, 0), (3, 0), (3, 1)), ((2, 0), (3, 1), (2, 1))],
    0b0111: [((0, 3), (1, 3), (2, 3))],
    0b1011: [((0, 2), (3, 2), (1, 2))],
    0b1101: [((0, 1), (2, 1), (3, 1))],
    0b1110: [((1, 0), (3, 0), (2, 0))],
}


def marching_tetrahedra(vol: TSDFVolume, iso: float = 0.0):
    """The TSDF zero isosurface as a triangle mesh (vertices [V, 3] world
    coordinates, faces [F, 3] int64 indices), host numpy: vectorised over
    the surface-crossing tetrahedra of the 6-tet cube decomposition, over
    observed voxels only."""
    tsdf = vol.tsdf.cpu().numpy().astype(np.float32)
    w = vol.weight.cpu().numpy().astype(np.float32)
    origin = vol.origin.cpu().numpy()
    dims = tsdf.shape
    # unobserved space keeps tsdf=1 and must not make faces against
    # observed negatives
    observed = w > 0

    # candidate cubes: all 8 corners observed, a sign change present
    gx, gy, gz = np.meshgrid(
        np.arange(dims[0] - 1), np.arange(dims[1] - 1), np.arange(dims[2] - 1), indexing="ij",
    )
    base = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)  # [N, 3]
    corner_idx = base[:, None, :] + _CORNERS[None]  # [N, 8, 3]
    cx, cy, cz = corner_idx[..., 0], corner_idx[..., 1], corner_idx[..., 2]
    vals = tsdf[cx, cy, cz]  # [N, 8]
    obs = observed[cx, cy, cz].all(axis=1)
    inside = vals < iso
    cross = inside.any(axis=1) & (~inside.all(axis=1))
    sel = np.flatnonzero(obs & cross)
    if len(sel) == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)
    base = base[sel]
    vals = vals[sel]  # [M, 8]
    corner_pos = (base[:, None, :] + _CORNERS[None]).astype(np.float32) * vol.voxel_size + origin

    tris = []
    for tet in _TETS:
        tv = vals[:, tet]  # [M, 4]
        tp = corner_pos[:, tet]  # [M, 4, 3]
        case = ((tv < iso) * np.array([1, 2, 4, 8])).sum(axis=1)
        for c, tri_list in _TET_TRIS.items():
            rows = np.flatnonzero(case == c)
            if len(rows) == 0:
                continue
            for tri in tri_list:
                pts = []
                for a, b in tri:
                    va, vb = tv[rows, a], tv[rows, b]
                    t = (iso - va) / np.where(np.abs(vb - va) < 1e-12, 1e-12, vb - va)
                    t = np.clip(t, 0.0, 1.0)[:, None]
                    pts.append(tp[rows, a] * (1 - t) + tp[rows, b] * t)
                tris.append(np.stack(pts, axis=1))  # [R, 3, 3]
    tri_pts = np.concatenate(tris, axis=0)  # [F, 3, 3]

    # weld vertices (quantised to 1e-5 voxel) so faces share indices; the
    # inverse index is flattened, whatever shape this numpy gives it
    flat = tri_pts.reshape(-1, 3)
    keys = np.round(flat / (vol.voxel_size * 1e-5)).astype(np.int64)
    uniq, index = np.unique(keys, axis=0, return_inverse=True)
    index = index.reshape(-1)
    verts = np.zeros((len(uniq), 3), np.float32)
    verts[index] = flat
    faces = index.reshape(-1, 3)
    # drop degenerate faces
    good = (faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2]) & (faces[:, 0] != faces[:, 2])
    return verts, faces[good]


def face_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    a = verts[faces[:, 1]] - verts[faces[:, 0]]
    b = verts[faces[:, 2]] - verts[faces[:, 0]]
    n = np.cross(a, b)
    norm = np.linalg.norm(n, axis=-1, keepdims=True)
    return n / np.maximum(norm, 1e-12)


def save_ply(path: str, points: np.ndarray, faces: np.ndarray | None = None):
    """ASCII PLY writer: a point cloud, or a triangle mesh when faces are
    given."""
    with open(path, "w") as f:
        f.write(
            "ply\nformat ascii 1.0\n"
            f"element vertex {len(points)}\n"
            "property float x\nproperty float y\nproperty float z\n"
        )
        if faces is not None:
            f.write(f"element face {len(faces)}\nproperty list uchar int vertex_indices\n")
        f.write("end_header\n")
        for p in points:
            f.write(f"{p[0]:.5f} {p[1]:.5f} {p[2]:.5f}\n")
        if faces is not None:
            for t in faces:
                f.write(f"3 {t[0]} {t[1]} {t[2]}\n")


def fly_through(
    vol: TSDFVolume,
    cam: PinholeCamera,
    poses,  # list of SE3 world-from-camera waypoints
    num_frames: int = 12,
    point_size: int = 1,
):
    """Shaded frames along an interpolated camera path over the extracted
    mesh -> list of [H, W, 3] uint8. A z-buffered splat of face centroids
    shaded by Lambertian |n . view|, headless. The poses are interpolated in
    the tangent space of each waypoint on CPU tensors; the rest is numpy."""
    verts, faces = marching_tetrahedra(vol)
    if len(faces) == 0:
        return []
    centroids = verts[faces].mean(axis=1)  # [F, 3]
    normals = face_normals(verts, faces)
    poses = [SE3(p.rot.detach().cpu().float(), p.trans.detach().cpu().float()) for p in poses]

    ts = np.linspace(0, len(poses) - 1, num_frames)
    frames = []
    h, w = cam.height, cam.width
    for t in ts:
        i = int(np.floor(t))
        j = min(i + 1, len(poses) - 1)
        alpha = t - i
        # interpolate in the tangent space of pose i
        rel = se3m.compose(se3m.inverse(poses[i]), poses[j])
        # float64 product rounded to float32, as numpy and jnp.asarray do
        tau = torch.from_numpy((se3m.se3_log(rel).numpy() * alpha).astype(np.float32))
        pose = se3m.compose(poses[i], se3m.se3_exp(tau))
        rot_cw = pose.rot.numpy().T
        t_w = pose.trans.numpy()
        pts_c = (centroids - t_w) @ rot_cw.T
        z = pts_c[:, 2]
        vis = z > 1e-6
        u = np.round(pts_c[:, 0] / np.maximum(z, 1e-6) * cam.fx + cam.cx).astype(np.int64)
        v = np.round(pts_c[:, 1] / np.maximum(z, 1e-6) * cam.fy + cam.cy).astype(np.int64)
        vis &= (u >= 0) & (u < w) & (v >= 0) & (v < h)
        # Lambertian shading against the view direction
        view = centroids - t_w
        view /= np.maximum(np.linalg.norm(view, axis=-1, keepdims=True), 1e-12)
        shade = np.abs((normals * view).sum(-1))
        img = np.zeros((h, w, 3), np.float32)
        zbuf = np.full((h, w), np.inf, np.float32)
        order = np.argsort(-z[vis])  # far-to-near painter over splats
        uu, vv, zz, ss = u[vis][order], v[vis][order], z[vis][order], shade[vis][order]
        for du in range(-point_size + 1, point_size):
            for dv in range(-point_size + 1, point_size):
                uc = np.clip(uu + du, 0, w - 1)
                vc = np.clip(vv + dv, 0, h - 1)
                img[vc, uc] = ss[:, None] * np.array([0.8, 0.75, 0.7])
                zbuf[vc, uc] = zz
        frames.append((np.clip(img, 0, 1) * 255).astype(np.uint8))
    return frames


def fuse_keyframes(system, dims=(64, 64, 64), margin: float = 0.5) -> TSDFVolume:
    """Fuse every keyframe depth of a SLAM run into one volume on the
    system's device; the bounds come from the keyframe positions and the
    median depth."""
    cam = system.cam
    store = system.store
    k = store.num_active
    centers = np.stack([store.pose(i).trans.cpu().numpy() for i in range(k)])
    depths = [store.depth_map(i).reshape(cam.height, cam.width) for i in range(k)]
    host = [d.cpu().numpy() for d in depths]
    med = float(np.median(np.concatenate([d.reshape(-1) for d in host])))
    lo = centers.min(0) - margin * med
    hi = centers.max(0) + (1.0 + margin) * med * 2
    voxel = float(np.max(hi - lo) / max(dims))
    vol = TSDFVolume.create(lo, dims, voxel, device=system.mapper.device)
    for i in range(k):
        vol = integrate(vol, depths[i], system.mapper.mask, store.pose(i), cam)
    return vol
