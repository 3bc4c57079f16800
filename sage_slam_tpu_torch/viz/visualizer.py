"""Headless map visualizer (port of sage_slam_tpu/viz/visualizer.py).

The reference renders keyframe surfels, camera frustums and links in an
OpenGL window. With no display, this renders the same content (keyframe
point clouds coloured by keyframe, frustums, trajectory, links) to PNG
with matplotlib's 3D backend, which is imported only inside the render
functions. Keyframe state is read from the card once per call.
"""

from __future__ import annotations

import numpy as np
import torch


def _pose_np(pose):
    return pose.rot.detach().cpu().numpy(), pose.trans.detach().cpu().numpy()


def keyframe_point_cloud(system, kf_id: int, stride: int = 4):
    """Back-project keyframe depth to world points [M, 3]."""
    cam = system.cam
    with system.store.lock:
        depth = system.store.depth_map(kf_id).cpu().numpy().reshape(cam.height, cam.width)
        rot, t = _pose_np(system.store.pose(kf_id))
    mask = system.mapper.mask.cpu().numpy().reshape(cam.height, cam.width)
    ys, xs = np.meshgrid(
        np.arange(0, cam.height, stride), np.arange(0, cam.width, stride), indexing="ij"
    )
    z = depth[ys, xs]
    valid = (mask[ys, xs] > 0.5) & (z > 1e-6) & np.isfinite(z)
    x3 = (xs - cam.cx) / cam.fx * z
    y3 = (ys - cam.cy) / cam.fy * z
    pts = np.stack([x3[valid], y3[valid], z[valid]], -1)
    return pts @ rot.T + t


def frustum_lines(pose, cam, scale: float = 0.1):
    """Camera frustum line segments in world coordinates."""
    rot, t = _pose_np(pose)
    w = cam.width / cam.fx * scale
    h = cam.height / cam.fy * scale
    corners = np.array(
        [[0, 0, 0], [-w, -h, scale * 2], [w, -h, scale * 2], [w, h, scale * 2], [-w, h, scale * 2]]
    )
    world = corners @ rot.T + t
    idx = [(0, 1), (0, 2), (0, 3), (0, 4), (1, 2), (2, 3), (3, 4), (4, 1)]
    return [(world[a], world[b]) for a, b in idx]


def render_map_png(system, path: str, max_keyframes: int = 10, point_stride: int = 4):
    """Render keyframe clouds, frustums, trajectory and links to PNG."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(10, 8))
    ax = fig.add_subplot(111, projection="3d")
    k = system.store.num_active
    shown = list(range(max(0, k - max_keyframes), k))
    cmap = plt.get_cmap("tab10")
    for i, kf_id in enumerate(shown):
        pts = keyframe_point_cloud(system, kf_id, point_stride)
        if len(pts):
            ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=0.5, color=cmap(i % 10), alpha=0.5)
        for a, b in frustum_lines(system.store.pose(kf_id), system.cam):
            ax.plot(*zip(a, b), color=cmap(i % 10), linewidth=0.8)
    kf_trans = system.store.variables.pose.trans[:k].cpu().numpy()
    for a in range(k):
        for b in system.store.connections(a):
            if a < b:
                ax.plot(*zip(kf_trans[a], kf_trans[b]), color="gray", linewidth=0.5, alpha=0.6)
    if system.trajectory:
        traj = torch.stack([p.trans for _, p in system.trajectory]).cpu().numpy()
        ax.plot(traj[:, 0], traj[:, 1], traj[:, 2], color="black", linewidth=1.2)
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_zlabel("z")
    ax.set_title(f"map: {k} keyframes, {len(system.trajectory)} frames")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def render_depth_png(system, kf_id: int, path: str):
    """Keyframe depth heatmap."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    cam = system.cam
    depth = system.store.depth_map(kf_id).cpu().numpy().reshape(cam.height, cam.width)
    fig, ax = plt.subplots(figsize=(6, 5))
    im = ax.imshow(depth, cmap="turbo")
    fig.colorbar(im, ax=ax)
    ax.set_title(f"keyframe {kf_id} depth")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path
