"""Trajectory evaluation: ATE with SE3/Sim3 alignment (port of
sage_slam_tpu/eval/ate.py, numpy, the port's own copy).

Umeyama alignment of the estimated positions onto ground truth (with
scale for the monocular Sim3 case), then the RMSE of the residual
translations; and the masked depth RMSE after median-scale alignment.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def umeyama_alignment(
    est: np.ndarray, gt: np.ndarray, with_scale: bool = True
) -> Tuple[float, np.ndarray, np.ndarray]:
    """est, gt [N, 3]. Returns (s, R, t) minimizing ||gt - (s R est + t)||."""
    mu_e = est.mean(0)
    mu_g = gt.mean(0)
    e = est - mu_e
    g = gt - mu_g
    cov = g.T @ e / len(est)
    u, d, vt = np.linalg.svd(cov)
    s_fix = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        s_fix[2, 2] = -1
    rot = u @ s_fix @ vt
    if with_scale:
        var_e = (e**2).sum() / len(est)
        scale = float(np.trace(np.diag(d) @ s_fix) / max(var_e, 1e-12))
    else:
        scale = 1.0
    t = mu_g - scale * rot @ mu_e
    return scale, rot, t


def ate_rmse(est_positions: np.ndarray, gt_positions: np.ndarray, align: str = "sim3") -> float:
    """Absolute trajectory error RMSE after alignment ('sim3' | 'se3' |
    'none')."""
    est = np.asarray(est_positions, np.float64)
    gt = np.asarray(gt_positions, np.float64)
    if est.shape != gt.shape:
        raise ValueError(f"estimate {est.shape} and ground truth {gt.shape} differ in shape")
    if align == "none":
        res = gt - est
    else:
        s, rot, t = umeyama_alignment(est, gt, with_scale=(align == "sim3"))
        res = gt - (s * est @ rot.T + t)
    return float(np.sqrt((res**2).sum(-1).mean()))


def associate(est: List[Tuple[float, np.ndarray]], gt: List[Tuple[float, np.ndarray]],
              max_dt: float = 0.02):
    """Timestamp association (nearest ground-truth timestamp within
    max_dt)."""
    gt_ts = np.array([t for t, _ in gt])
    pairs = []
    for ts, pos in est:
        i = int(np.argmin(np.abs(gt_ts - ts)))
        if abs(gt_ts[i] - ts) <= max_dt:
            pairs.append((pos, gt[i][1]))
    if not pairs:
        return np.zeros((0, 3)), np.zeros((0, 3))
    e, g = zip(*pairs)
    return np.stack(e), np.stack(g)


def depth_rmse(est_depth: np.ndarray, gt_depth: np.ndarray, mask: np.ndarray,
               align_scale: bool = True) -> float:
    """Masked depth RMSE, optionally after median-scale alignment (the
    monocular convention)."""
    m = mask > 0.5
    e = est_depth[m]
    g = gt_depth[m]
    if align_scale and len(e) > 0:
        med_e = np.median(e)
        if abs(med_e) > 1e-12:
            e = e * (np.median(g) / med_e)
    return float(np.sqrt(((e - g) ** 2).mean())) if len(e) else float("nan")
