"""Pinhole camera and camera pyramid (port of
sage_slam_tpu/geometry/camera.py; plain Python, identical).

Cameras are hashable frozen dataclasses; their intrinsics enter the
factor code as Python floats.

Pyramid construction matches the reference: each level halves the previous
integer width/height and rescales intrinsics by the realized ratio
(reference: common/camera_pyramid.h:18-32, pinhole_camera_impl.h:122-132).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class PinholeCamera:
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int

    def resized(self, new_width: int, new_height: int) -> "PinholeCamera":
        """Rescale intrinsics for a new viewport (pinhole_camera_impl.h:122-132)."""
        x_ratio = new_width / self.width
        y_ratio = new_height / self.height
        return PinholeCamera(
            fx=self.fx * x_ratio,
            fy=self.fy * y_ratio,
            cx=self.cx * x_ratio,
            cy=self.cy * y_ratio,
            width=new_width,
            height=new_height,
        )

    @property
    def num_pixels(self) -> int:
        return self.width * self.height


@dataclasses.dataclass(frozen=True)
class CameraPyramid:
    """Half-resolution camera pyramid; level 0 is the finest."""

    cameras: Tuple[PinholeCamera, ...]

    @staticmethod
    def build(cam: PinholeCamera, levels: int) -> "CameraPyramid":
        cams = [cam]
        for _ in range(1, levels):
            prev = cams[-1]
            cams.append(prev.resized(prev.width // 2, prev.height // 2))
        return CameraPyramid(tuple(cams))

    def __getitem__(self, i: int) -> PinholeCamera:
        return self.cameras[i]

    def __len__(self) -> int:
        return len(self.cameras)

    @property
    def levels(self) -> int:
        return len(self.cameras)

    @property
    def level_offsets(self) -> Tuple[int, ...]:
        """Start offset of each level in the flattened (concatenated) pyramid
        layout ``[C, N0 + N1 + ...]`` used by all factor kernels."""
        offsets = []
        acc = 0
        for cam in self.cameras:
            offsets.append(acc)
            acc += cam.num_pixels
        return tuple(offsets)

    @property
    def total_pixels(self) -> int:
        return sum(c.num_pixels for c in self.cameras)
