"""Warp-overlay debug rendering (port of sage_slam_tpu/viz/warp_display.py,
the reference's DisplaySE3Warp with checkerboard blending).

Warps a frame's content onto a keyframe's pixels with the relative pose
and renders keyframe / checkerboard blend / frame side by side, the
reference's visual check of alignment quality.
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry import interp


def se3_warp_image(img1_flat, depth0_flat, mask_flat, rot10, t10, cam, eps: float = 1e-6):
    """Backward-warp frame-1 content [C, HW] onto frame-0 pixels through
    frame 0's depth [HW] -> ([C, H, W] warped, [H, W] validity), numpy.
    The inputs may be tensors (on any one device) or arrays."""
    depth0_flat = torch.as_tensor(depth0_flat, dtype=torch.float32)
    dev = depth0_flat.device
    img1_flat, mask_flat, rot10, t10 = (
        torch.as_tensor(x, dtype=torch.float32, device=dev) for x in (img1_flat, mask_flat, rot10, t10)
    )
    hw = depth0_flat.shape[0]
    homo = interp.locations_1d_to_homo(torch.arange(hw, device=dev), cam)
    x1 = depth0_flat[:, None] * (homo @ rot10.T) + t10
    pos = (x1[:, 2] > eps).to(img1_flat.dtype)
    u = x1[:, 0] / torch.clamp(x1[:, 2], min=eps) * cam.fx + cam.cx
    v = x1[:, 1] / torch.clamp(x1[:, 2], min=eps) * cam.fy + cam.cy
    sampled = interp.bilinear_flat(img1_flat, u, v, cam.width, cam.height)
    valid = interp.nearest_flat(mask_flat, u, v, cam.width, cam.height) * pos
    c = img1_flat.shape[0]
    return (
        (sampled * mask_flat[None]).cpu().numpy().reshape(c, cam.height, cam.width),
        valid.cpu().numpy().reshape(cam.height, cam.width),
    )


def checkerboard(h: int, w: int, grid: int = 7) -> np.ndarray:
    """The reference's blending checkerboard (GenerateCheckerboard)."""
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    return (((ys * grid // h) + (xs * grid // w)) % 2).astype(np.float32)


def render_warp_png(system, kf_id: int, fr_data, rot10, t10, path: str):
    """Side by side: keyframe features | checkerboard warp blend | frame."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    cam = system.cam
    hw = cam.height * cam.width
    kf_feat = system.store.row("feat_pyr", kf_id)[:3, :hw].cpu().numpy().reshape(3, cam.height, cam.width)
    fr_feat = fr_data.feat_pyr[:3, :hw]
    warped, _ = se3_warp_image(
        fr_feat, system.store.depth_map(kf_id), system.mapper.mask_flat, rot10, t10, cam
    )
    fr_feat = fr_feat.cpu().numpy().reshape(3, cam.height, cam.width)
    cb = checkerboard(cam.height, cam.width)
    blend = np.where(cb[None] > 0.5, warped, kf_feat)

    def norm(x):
        lo, hi = x.min(), x.max()
        return (x - lo) / max(hi - lo, 1e-8)

    fig, axes = plt.subplots(1, 3, figsize=(12, 4))
    for ax, img, title in zip(axes, [kf_feat, blend, fr_feat], ["keyframe", "checkerboard warp", "frame"]):
        ax.imshow(norm(img).transpose(1, 2, 0))
        ax.set_title(title)
        ax.axis("off")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path
