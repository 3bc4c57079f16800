"""TUM trajectory IO (port of sage_slam_tpu/io/tum_io.py).

Format: ``timestamp tx ty tz qx qy qz qw`` per line. ``write_tum`` takes
the port's (timestamp, SE3) pairs, which may live on the card: the whole
trajectory reaches the host in one read, then each line is written as the
JAX package writes it (float32 pose values widened to float64), so both
packages write the same bytes for the same poses.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..geometry.se3 import SE3


def rotation_to_quaternion(rot: np.ndarray) -> np.ndarray:
    """[3,3] -> (qx, qy, qz, qw), w >= 0."""
    m = np.asarray(rot, np.float64)
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        qw = 0.25 * s
        qx = (m[2, 1] - m[1, 2]) / s
        qy = (m[0, 2] - m[2, 0]) / s
        qz = (m[1, 0] - m[0, 1]) / s
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        qw = (m[2, 1] - m[1, 2]) / s
        qx = 0.25 * s
        qy = (m[0, 1] + m[1, 0]) / s
        qz = (m[0, 2] + m[2, 0]) / s
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        qw = (m[0, 2] - m[2, 0]) / s
        qx = (m[0, 1] + m[1, 0]) / s
        qy = 0.25 * s
        qz = (m[1, 2] + m[2, 1]) / s
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        qw = (m[1, 0] - m[0, 1]) / s
        qx = (m[0, 2] + m[2, 0]) / s
        qy = (m[1, 2] + m[2, 1]) / s
        qz = 0.25 * s
    q = np.array([qx, qy, qz, qw])
    if qw < 0:
        q = -q
    return q


def quaternion_to_rotation(q: np.ndarray) -> np.ndarray:
    """(qx, qy, qz, qw) -> [3,3]."""
    x, y, z, w = np.asarray(q, np.float64)
    n = x * x + y * y + z * z + w * w
    s = 0.0 if n == 0 else 2.0 / n
    return np.array(
        [
            [1 - s * (y * y + z * z), s * (x * y - z * w), s * (x * z + y * w)],
            [s * (x * y + z * w), 1 - s * (x * x + z * z), s * (y * z - x * w)],
            [s * (x * z - y * w), s * (y * z + x * w), 1 - s * (x * x + y * y)],
        ]
    )


def write_tum(path: str, trajectory: List[Tuple[float, SE3]]):
    rots = trans = np.zeros((0, 3))
    if trajectory:
        rots = torch.stack([p.rot for _, p in trajectory]).cpu().numpy()
        trans = torch.stack([p.trans for _, p in trajectory]).cpu().numpy()
    with open(path, "w") as f:
        for (ts, _), rot, tr in zip(trajectory, rots, trans):
            t = np.array(tr, np.float64)
            q = rotation_to_quaternion(rot)
            f.write(
                f"{ts:.6f} {t[0]:.8f} {t[1]:.8f} {t[2]:.8f} "
                f"{q[0]:.8f} {q[1]:.8f} {q[2]:.8f} {q[3]:.8f}\n"
            )


def read_tum(path: str) -> List[Tuple[float, np.ndarray, np.ndarray]]:
    """Returns [(ts, t [3], rot [3,3])]."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(x) for x in line.split()]
            ts, tx, ty, tz, qx, qy, qz, qw = vals[:8]
            out.append((ts, np.array([tx, ty, tz]), quaternion_to_rotation([qx, qy, qz, qw])))
    return out
