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
out as io.dataset ``FrameRecord``s, the way the driver reads a camera.

``perfect_prior_system`` / ``perfect_prior_run`` are
tests/test_ate_regression.py's ground-truth regression in the port.
"""

from __future__ import annotations

import os
from typing import Callable, Iterator, NamedTuple, Optional

import numpy as np
import torch

from .device import resolve_device
from .geometry.camera import CameraPyramid, PinholeCamera
from .geometry.interp import locations_1d_to_homo
from .geometry.se3 import SE3, se3_exp
from .io.dataset import FrameRecord
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


# the JAX package's sample ids (jax.random) for perfect_prior_system's 10
# frames (loc1d [10, 256], by timestamp) and its keyframes' match keypoints
# (keypoints [12, 32], by keyframe id); tests/test_torch_demo.py checks the
# file against JAX's draws
PERFECT_PRIOR_DRAWS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "eval",
                                   "perfect_prior_draws.npz")


def perfect_prior_system(num_frames: int = 10, motion: float = 0.06, device=None,
                         draws: Optional[str] = None):
    """tests/test_ate_regression.py's ``perfect_prior_system`` in the port ->
    (SlamSystem, io.dataset.SyntheticInterface): an exact lateral motion
    over a fronto-parallel unit-depth plane at 32x40 -> 16x20, the depth
    network pinned to the constant (exact) prior, the handcrafted
    shift-equivariant feature bank, binary gates, no coarse-to-fine, 256 of
    the 320 pixels sampled. The estimator alone is measured: no learned
    weight enters the result. ``draws`` (an npz such as
    PERFECT_PRIOR_DRAWS) replaces the port's seeded sample ids and
    keypoints with the file's, so the run sees the JAX test's inputs."""
    from .config import KeyframeConfig, MapperConfig, SlamConfig, TrackerConfig
    from .frontend.slam import SlamSystem
    from .io.dataset import SyntheticInterface
    from .models import depth_network, feature_network

    h_out, w_out = 16, 20
    cs, fs = 4, 8
    cfg = SlamConfig(
        net_input_size=(h_out * 2, w_out * 2), net_output_size=(h_out, w_out), code_size=cs,
        feat_size=fs, pyramid_levels=3, max_keyframes=12,
        tracker=TrackerConfig(max_num_iters=40, desc_num_keypoints=32, use_reprojection=True,
                              soft_inlier_gate=False, coarse_to_fine=False),
        mapper=MapperConfig(pho_num_samples=256, desc_num_keypoints=32, window_size=8,
                            max_gn_iters=10, soft_inlier_gate=False),
        keyframe=KeyframeConfig(min_average_motion=0.02),
    )
    dnet = depth_network.constant_depth_params(depth_network.init_network(
        torch.Generator().manual_seed(1),
        depth_network.DepthNetConfig(filter_list=(4, 8, 16), bottleneck=16, bias_inner=(8, 1),
                                     basis_inner=((8, cs),))))
    fnet = feature_network.init_network(
        torch.Generator().manual_seed(2),
        feature_network.FeatureNetConfig(filter_list=(4, 8, 16), bottleneck=16, desc_inner=(8, fs),
                                         map_inner=(8, fs), mode="handcrafted"))
    data = SyntheticInterface(num_frames=num_frames, height=h_out * 2, width=w_out * 2, seed=0,
                              motion_scale=motion)
    out_cam = data.intrinsics().resized(w_out, h_out)
    system = SlamSystem(cfg, out_cam, np.ones((h_out, w_out), np.float32), dnet, fnet,
                        device=device)
    if draws is not None:
        ids = np.load(draws)
        loc1d, keypoints = ids["loc1d"], ids["keypoints"]
        system.mapper.location_source = lambda ts: loc1d[int(round(ts))]
        system.keypoint_source = lambda kf_id: keypoints[kf_id]
    return system, data


def perfect_prior_run(system, data, refine_iters: int = 8) -> dict:
    """test_ate_on_synthetic_lateral_motion's run and measurements:
    bootstrap, process_frame on every later frame with a mapping_step after
    each new keyframe, refine_mapping(refine_iters); then the as-tracked
    frame Sim3-ATE, the keyframe Sim3-ATE (against each keyframe's frame
    pose), the span |gt_last - gt_first|, the estimate's own travel and the
    scale-aligned depth RMSE of each keyframe against the unit plane."""
    from .eval import ate

    frames = list(data.frames())
    dev = system.device
    system.bootstrap(frames[0].timestamp, torch.as_tensor(frames[0].image, device=dev))
    lost = []
    for rec in frames[1:]:
        res = system.process_frame(rec.timestamp, torch.as_tensor(rec.image, device=dev))
        lost.append(res.tracking_lost)
        if res.new_keyframe:
            system.mapper.mapping_step()
    system.refine_mapping(refine_iters)
    est = torch.stack([p.trans for _, p in system.trajectory]).cpu().numpy()
    gt = np.stack([f.pose_wf[:3, 3] for f in frames])
    kf_traj = system.keyframe_trajectory()
    kf_est = torch.stack([p.trans for _, p in kf_traj]).cpu().numpy()
    kf_gt = np.stack([frames[int(round(ts))].pose_wf[:3, 3] for ts, _ in kf_traj])
    cam = system.cam
    ones = np.ones((cam.height, cam.width), np.float32)
    depths = torch.stack([system.store.depth_map(i) for i in range(system.store.num_active)])
    return dict(
        tracking_lost=lost,
        frame_sim3=ate.ate_rmse(est, gt, align="sim3"),
        keyframe_sim3=ate.ate_rmse(kf_est, kf_gt, align="sim3"),
        span=float(np.linalg.norm(gt[-1] - gt[0])),
        travel=float(np.linalg.norm(est[-1] - est[0])),
        depth_rmse=[ate.depth_rmse(d.reshape(cam.height, cam.width), ones, ones, align_scale=True)
                    for d in depths.cpu().numpy()],
        keyframes=system.store.num_active,
    )
