"""Synthetic window-BA problems, built in the port from a numpy seed.

``bench_problem`` reproduces the construction of bench.py (the window-BA
bench point: K=8 keyframes, 64x80 output, CS=FS=16, 4 pyramid levels,
3072 samples, 24 photometric + 24 geometric ring edges);
``graft_problem`` reproduces ``__graft_entry__._build_problem`` (K=4,
32x40, CS=FS=16, 4 levels, 512 samples, consecutive-pair edges). The
numpy draws are made in the same order as there, so the inputs are the
same; the pyramid is computed by the port.

Both build on the card unless ``device="cpu"`` is passed.

``mapper_scene`` makes a video for the mapper (numpy arrays: images, a
smooth trajectory and a circular video mask); ``slam_scene`` is the same
video with enough frames for the tracker to run between keyframes;
``loop_scene`` goes out over the same plane and comes back, so that its
last frame repeats frame 0's view. ``SceneSource`` hands a scene's frames
out as ``FrameRecord``s, the way the driver reads a camera.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, NamedTuple, Optional

import numpy as np
import torch

from .device import resolve_device
from .geometry.camera import CameraPyramid, PinholeCamera
from .geometry.interp import locations_1d_to_homo
from .geometry.se3 import SE3, se3_exp
from .ops.photometric import sample_source_features
from .ops.pyramid import gaussian_pyramid_with_grad, mask_pyramid
from .solver.ba import BAProblem, EdgeTable, PriorTable, WindowData
from .solver.graph import Variables


def _window(rng, feat, k, h, w, cs, levels, n, cam, pyr, dev) -> WindowData:
    """One feature image shared by all K keyframes (draws: jac, loc1d)."""
    mask = torch.ones((h, w), dtype=torch.float32, device=dev)
    fpyr, gpyr = gaussian_pyramid_with_grad(
        torch.from_numpy(feat).to(dev), mask_pyramid(mask, levels), levels
    )
    bias = np.full(h * w, 1.2, np.float32)
    jac = (rng.standard_normal((h * w, cs)) * 0.02).astype(np.float32)
    loc1d = torch.from_numpy(
        rng.choice(h * w, size=n, replace=False).astype(np.int64)
    ).to(dev)
    homo = locations_1d_to_homo(loc1d, cam)
    srcf = sample_source_features(fpyr, loc1d, pyr)
    t = pyr.total_pixels
    c = fpyr.shape[0]
    return WindowData(
        loc1d=loc1d[None].expand(k, n).contiguous(),
        homo=homo[None].expand(k, n, 3).contiguous(),
        bias_flat=torch.from_numpy(bias).to(dev)[None].expand(k, h * w).contiguous(),
        jac_flat=torch.from_numpy(jac).to(dev)[None].expand(k, h * w, cs).contiguous(),
        feat_pyr=fpyr[:, None].expand(c, k, t).contiguous(),
        grad_pyr=gpyr[:, :, None].expand(2, c, k, t).contiguous(),
        src_feats=srcf[None].expand(k, *srcf.shape).contiguous(),
        avg_sq_bias=torch.full((k,), float(np.mean(bias**2)), device=dev),
        mask_flat=mask.reshape(-1),
    )


def _priors(k, dev) -> PriorTable:
    first = torch.zeros(k, device=dev)
    first[0] = 1.0
    return PriorTable(
        code_valid=torch.ones(k, device=dev),
        scale_valid=first.clone(),
        scale_init=torch.ones(k, device=dev),
        pose_valid=first.clone(),
        pose_target=SE3.identity((k,), device=dev),
    )


def _edges(i0, i1, dev) -> EdgeTable:
    i0 = torch.as_tensor(np.asarray(i0, np.int64), device=dev)
    i1 = torch.as_tensor(np.asarray(i1, np.int64), device=dev)
    return EdgeTable(i0, i1, torch.ones(i0.shape[0], device=dev))


def _camera(h, w, levels):
    cam = PinholeCamera(
        fx=w * 1.1, fy=w * 1.1, cx=w / 2 - 0.5, cy=h / 2 - 0.5, width=w, height=h
    )
    return cam, CameraPyramid.build(cam, levels)


def bench_problem(device=None, seed=0, k=8, h=64, w=80, cs=16, fs=16, levels=4,
                  n=3072, n_photo=24, n_geo=24):
    """bench.py's problem -> (variables, problem, cam_pyr)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    cam, pyr = _camera(h, w, levels)
    feat = rng.standard_normal((fs, h, w)).astype(np.float32) * 0.3
    window = _window(rng, feat, k, h, w, cs, levels, n, cam, pyr, dev)

    def ring(count):
        i0 = np.arange(count) % k
        return _edges(i0, (i0 + 1 + (np.arange(count) // k)) % k, dev)

    problem = BAProblem(window, ring(n_photo), ring(n_geo), _priors(k, dev))
    taus = (rng.standard_normal((k, 6)) * 0.01).astype(np.float32)
    variables = Variables(
        se3_exp(torch.from_numpy(taus).to(dev)),
        torch.zeros((k, cs), device=dev),
        torch.ones(k, device=dev),
    )
    return variables, problem, pyr


class MapperScene(NamedTuple):
    """A synthetic video for the mapper, as numpy arrays."""

    images: np.ndarray  # [F, 3, H, W] float32 in [0, 1]
    rot: np.ndarray  # [F, 3, 3] world-from-camera rotations
    trans: np.ndarray  # [F, 3] world-from-camera translations
    mask_in: np.ndarray  # [H, W] circular video mask, input resolution
    mask_out: np.ndarray  # [H/2, W/2] the same mask at the networks' output
    camera: PinholeCamera  # output-resolution intrinsics


# radius of mapper_scene's circular mask over the image width
MASK_RADIUS = 0.46


def _plane_video(trans: np.ndarray, seed: int, height: int, width: int) -> MapperScene:
    """A camera at translations ``trans`` [F, 3] (no rotation) over a
    textured fronto-parallel plane at depth 1, seen through a circular
    endoscope-like mask of radius ``MASK_RADIUS * width`` that the image's
    top and bottom clip. The texture is a sum of random sinusoids per
    channel from ``numpy.random.default_rng(seed)``, so each frame is the
    texture shifted by the camera's motion with no resampling, and two
    frames at the same translation are the same image."""
    rng = np.random.default_rng(seed)
    n_waves = 12
    freq = rng.uniform(0.04, 0.35, size=(3, n_waves, 2)) * rng.choice([-1, 1], size=(3, n_waves, 2))
    phase = rng.uniform(0, 2 * np.pi, size=(3, n_waves))
    amp = rng.uniform(0.2, 1.0, size=(3, n_waves))
    amp /= amp.sum(axis=1, keepdims=True) * 2.2
    f_in = width * 1.1
    num_frames = trans.shape[0]
    rot = np.broadcast_to(np.eye(3, dtype=np.float32), (num_frames, 3, 3)).copy()
    yy, xx = np.mgrid[:height, :width].astype(np.float64)
    images = np.empty((num_frames, 3, height, width), np.float32)
    for f in range(num_frames):
        # a plane at depth 1 - t_z: the camera's motion shifts the image by
        # -f * t / depth pixels
        depth = 1.0 - trans[f, 2]
        sx = (xx - width / 2) * depth + f_in * trans[f, 0]
        sy = (yy - height / 2) * depth + f_in * trans[f, 1]
        arg = freq[..., 0, None, None] * sx + freq[..., 1, None, None] * sy + phase[..., None, None]
        images[f] = 0.5 + np.sum(amp[..., None, None] * np.sin(arg), axis=1)
    mask_in = (((xx - (width - 1) / 2) ** 2 + (yy - (height - 1) / 2) ** 2)
               <= (MASK_RADIUS * width) ** 2).astype(np.float32)
    h, w = height // 2, width // 2
    camera = PinholeCamera(fx=f_in / 2, fy=f_in / 2, cx=w / 2 - 0.5, cy=h / 2 - 0.5,
                           width=w, height=h)
    return MapperScene(np.clip(images, 0.0, 1.0), rot, trans, mask_in, mask_in[::2, ::2].copy(),
                       camera)


def _arc(num_points: int, radius: float) -> np.ndarray:
    """A quarter circle of ``radius`` with a forward drift of 0.002 per
    point -> translations [num_points, 3]."""
    angles = np.linspace(0.0, np.pi / 2, num_points)
    return np.stack(
        [radius * np.sin(angles), radius * (1 - np.cos(angles)), 0.002 * np.arange(num_points)], axis=-1
    ).astype(np.float32)


def mapper_scene(num_frames: int = 16, seed: int = 0, height: int = 128,
                 width: int = 160, radius: float = 0.05) -> MapperScene:
    """The mapper's video: the plane of ``_plane_video`` seen along a
    quarter circle of ``radius``, with a forward drift of 0.002 per
    frame."""
    return _plane_video(_arc(num_frames, radius), seed, height, width)


# slam_scene: 24 frames on a quarter circle of radius 0.2, about 1.2
# output pixels of motion per frame at 64x80, so that the keyframe
# decision fires every few frames (on mapper_scene's radius of 0.05 the
# whole sequence moves under one keyframe's worth)
SLAM_FRAMES = 24
SLAM_RADIUS = 0.2


def slam_scene(num_frames: int = SLAM_FRAMES, seed: int = 0, height: int = 128,
               width: int = 160) -> MapperScene:
    """The system's sequence: mapper_scene's video (same mask, same seed
    rule) over more frames and a wider path, so the tracker runs between
    keyframes."""
    return mapper_scene(num_frames, seed, height, width, radius=SLAM_RADIUS)


def graft_problem(device=None, seed=0, k=4, h=32, w=40, cs=16, fs=16, levels=4, n=512):
    """__graft_entry__._build_problem's problem -> (variables, problem,
    cam_pyr)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    cam, pyr = _camera(h, w, levels)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    feat = np.stack(
        [np.sin(0.2 * xx + 0.61 * c) * np.cos(0.15 * yy + 0.37 * c) for c in range(fs)]
    ).astype(np.float32)
    window = _window(rng, feat, k, h, w, cs, levels, n, cam, pyr, dev)
    i0, i1 = [], []
    for a in range(k - 1):
        i0 += [a, a + 1]
        i1 += [a + 1, a]
    edges = _edges(i0, i1, dev)
    problem = BAProblem(window, edges, edges, _priors(k, dev))
    taus = np.zeros((k, 6), np.float32)
    taus[1:] = rng.standard_normal((k - 1, 6)).astype(np.float32) * 0.01
    variables = Variables(
        se3_exp(torch.from_numpy(taus).to(dev)),
        torch.zeros((k, cs), device=dev),
        torch.ones(k, device=dev),
    )
    return variables, problem, pyr


# loop_scene: out and back over slam_scene's path, 43 frames, so that with
# a keyframe every 4th frame the last keyframe (frame 40) sits 2 frames
# from frame 0's view and 10 keyframes after keyframe 0 (LoopConfig's
# global_active_window), and the last frame repeats frame 0's view
LOOP_FRAMES = 43


def loop_scene(num_frames: int = LOOP_FRAMES, seed: int = 0, height: int = 128, width: int = 160,
               radius: float = SLAM_RADIUS) -> MapperScene:
    """slam_scene's plane and mask out and back: frame f is at point j of a
    quarter circle of ``radius``, j = f on the way out (f < num_frames // 2)
    and j = num_frames - 1 - f on the way back, so the last frame repeats
    frame 0's view exactly."""
    half = num_frames // 2
    j = np.array([f if f < half else num_frames - 1 - f for f in range(num_frames)])
    return _plane_video(_arc(int(j.max()) + 1, radius)[j], seed, height, width)


@dataclasses.dataclass
class FrameRecord:
    timestamp: float
    image: np.ndarray  # [3, H, W] float32 in [0, 1]


class SceneSource:
    """A scene as a camera: ``frames()`` yields FrameRecord(0.1 f, image f).
    ``before_frame(f)``, when given, runs just before frame f is handed out
    (on the reading thread)."""

    def __init__(self, scene: MapperScene, before_frame: Optional[Callable[[int], None]] = None):
        self.scene = scene
        self.before_frame = before_frame

    def frames(self) -> Iterator[FrameRecord]:
        for f, image in enumerate(self.scene.images):
            if self.before_frame is not None:
                self.before_frame(f)
            yield FrameRecord(0.1 * f, image)
