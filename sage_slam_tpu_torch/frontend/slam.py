"""SLAM orchestrator without loop closure (port of
sage_slam_tpu/frontend/slam.py).

* process_frame: build the frame, select the reference keyframe (CLOSEST
  by pose distance, or LAST / FIRST), descriptor matching and robust
  registration against it, 6-DoF LM tracking (photometric + reprojection),
  the keyframe decision on the area / inlier / motion / descriptor ratios,
  and keyframe creation with back connections gated by the descriptor
  inlier ratio;
* mapping: the caller runs ``mapper.mapping_step()`` after each new
  keyframe, and ``refine_mapping`` at the end.

Host reads per frame: one for the reference keyframe's argmin, the
tracker's (see tracker/tracker.py), one batched read of every per-frame
metric, and on a keyframe frame one for the candidates' ratios and one for
the depth-scale median (Mapper.correct_depth_scale).

The store is written in place, so everything kept across frames (the
trajectory's poses, the frame references' poses and scales) is a copy,
never a view of a store row.

Not ported here: the BoW database and the loop-closure methods
(``detect_local_loop``, ``detect_global_loop``, ``close_global_loops``,
``local_loop_tick``, ``global_loop_tick``), which raise
NotImplementedError.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, List, Optional

import torch

from ..config import SlamConfig
from ..device import resolve_device
from ..geometry import interp
from ..geometry.camera import CameraPyramid, PinholeCamera
from ..geometry.se3 import SE3, compose, inverse, pose_distance
from ..mapping.keyframe_store import FrameData
from ..mapping.mapper import Mapper
from ..tracker import tracker
from ..tracker.matching_geo import MatchGeoResult, feature_matching_geo
from ..tracker.tracker import TrackerRef, TrackerTarget, TrackTerms

LOOPS_NOT_PORTED = "loop closure is not ported yet (ROADMAP.md, Queue 1 item 11)"


@dataclasses.dataclass
class LoopInfo:
    detected: bool = False
    id_ref: int = -1
    pose_cur_ref: Optional[SE3] = None
    query_scale: float = 1.0
    ref_scale: float = 1.0
    desc_inlier_ratio: float = 0.0
    # verification quality in (0, 1]; scales a loop edge's pose-graph weight
    quality: float = 1.0


@dataclasses.dataclass
class FrameResult:
    pose: SE3
    tracked: bool
    new_keyframe: bool
    keyframe_id: int
    area_ratio: float
    inlier_ratio: float
    average_motion: float
    desc_inlier_ratio: float
    tracker_error: float
    tracking_lost: bool = False


@dataclasses.dataclass
class SlamStatistics:
    """Pushed to ``stats_callback`` after every frame."""

    inlier_ratio: float = 0.0
    area_ratio: float = 0.0
    pose_distance: float = 0.0
    tracker_error: float = 0.0
    num_keyframes: int = 0


def _match_seed(kf_id: int) -> int:
    """The keypoint seed of a reference keyframe (the JAX package's hash;
    its uint32 form in the batched ratios gives the same integer)."""
    return (kf_id * 2654435761 + 1) & 0x7FFFFFFF


def _copy_pose(p: SE3) -> SE3:
    return SE3(p.rot.clone(), p.trans.clone())


class SlamSystem:
    def __init__(
        self,
        cfg: SlamConfig,
        camera: PinholeCamera,
        video_mask,  # [h, w] output-resolution mask
        depth_net,
        feat_net,
        voc=None,
        video_mask_in=None,  # [H, W] input-resolution mask for the networks
        device=None,
    ):
        if voc is not None:
            raise NotImplementedError(f"a vocabulary (BoW database): {LOOPS_NOT_PORTED}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.cam = camera
        self.cam_pyr = CameraPyramid.build(camera, cfg.pyramid_levels)
        self.mapper = Mapper(cfg, self.cam_pyr, video_mask, depth_net, feat_net,
                             video_mask_in=video_mask_in, device=self.device)
        self.store = self.mapper.store
        self.voc = None
        self.bow_db = None
        self.curr_kf: int = -1
        self.pose_ck: SE3 = SE3.identity(device=self.device)  # camera-from-keyframe
        self.trajectory: List[tuple] = []  # (ts, SE3 world-from-camera), as tracked
        # per frame (ts, ref_kf, pose_ck, ref scale at track time): enough to
        # re-express every frame pose from the final keyframe poses
        # (finalized_trajectory)
        self.frame_refs: List[tuple] = []
        self.global_loops: dict = {}
        self.force_keyframe = False
        self._visited: List[int] = []
        self.stats_callback = None  # receives SlamStatistics per frame
        self.pose_callback = None  # receives (timestamp, SE3) per frame
        # injection point: ``kf_id -> keypoint ids [K]`` replaces the seeded
        # keypoint draw of the matching against keyframe kf_id
        self.keypoint_source: Optional[Callable] = None
        # telemetry of the last process_frame: the tracker's LM iterations
        # and the reference keyframe it tracked against
        self.last_track_iters = 0
        self.last_track_ref = -1

    def clone(self, device) -> "SlamSystem":
        """An independent copy of this system on ``device`` (the mapper
        through Mapper.clone; poses and frame references copied), to hold
        one device's frame against another's from the same state."""
        dev = resolve_device(device)
        to = lambda t: t.to(dev, copy=True)  # noqa: E731
        out = copy.copy(self)
        out.device = dev
        out.mapper = self.mapper.clone(dev)
        out.store = out.mapper.store
        out.pose_ck = SE3(to(self.pose_ck.rot), to(self.pose_ck.trans))
        out.trajectory = [(ts, SE3(to(p.rot), to(p.trans))) for ts, p in self.trajectory]
        out.frame_refs = [(ts, ref, SE3(to(p.rot), to(p.trans)), to(s))
                          for ts, ref, p, s in self.frame_refs]
        out.global_loops = dict(self.global_loops)
        out._visited = list(self._visited)
        return out

    # ------------------------------------------------------------------

    def bootstrap(self, timestamp: float, image=None, frame: Optional[FrameData] = None) -> int:
        """The first keyframe; ``frame`` passes a prebuilt frame."""
        with self.store.lock:
            kf_id = self.mapper.init_one_frame(timestamp, image, frame=frame)
            self.curr_kf = kf_id
            self.pose_ck = SE3.identity(device=self.device)
            self._visited.append(kf_id)
            pose = _copy_pose(self.store.pose(kf_id))
            scale = self.store.variables.scale[kf_id].clone()
        self.trajectory.append((timestamp, pose))
        self.frame_refs.append((timestamp, kf_id, SE3.identity(device=self.device), scale))
        return kf_id

    # ------------------------------------------------------------------

    def _tracker_ref(self, kf_id: int) -> TrackerRef:
        loc1d = self.store.row("loc1d", kf_id)
        return TrackerRef(
            photo_homo0=self.store.row("homo", kf_id),
            photo_dpts0=self.store.depth_map(kf_id)[loc1d],
            cat_photo_feats0=self.store.row("src_feats", kf_id),
        )

    def _target(self, fr: FrameData) -> TrackerTarget:
        # the frame's own sampling tables, built once by build_frame
        return TrackerTarget(
            feat_pyr=fr.feat_pyr, grad_pyr=fr.grad_pyr, mask_flat=self.mapper.mask_flat,
            packed_fg=fr.packed_fg, packed_feat=fr.packed_feat, dense_fg=fr.dense_fg,
            dense_feat=fr.dense_feat,
        )

    def _keypoints(self, kf_id: int):
        if self.keypoint_source is None:
            return None
        return self.mapper._ids(self.keypoint_source(kf_id))

    def _matching(self, kf_id: int, fr: FrameData, fr_depth) -> MatchGeoResult:
        cfgt = self.cfg.tracker
        return feature_matching_geo(
            _match_seed(kf_id), self.store.row("feat_desc", kf_id), fr.feat_desc_flat,
            self.mapper.valid_loc1d, self.store.depth_map(kf_id), fr_depth, self.cam,
            cfgt.desc_num_keypoints, cfgt.desc_cyc_consis_thresh,
            cfgt.teaser_noise_bound_multiplier, estimate_scale=True, dpt_scale_1=fr.scale,
            keypoints=self._keypoints(kf_id),
        )

    @staticmethod
    def _frame_depth(fr: FrameData):
        return fr.scale * (fr.bias_flat + fr.jac_flat @ fr.code)

    def _match_geo(self, kf_id: int, fr: FrameData) -> MatchGeoResult:
        return self._matching(kf_id, fr, self._frame_depth(fr))

    def _match_geo_ratios(self, ids: List[int], fr: FrameData) -> List[float]:
        """relative_desc_inlier_ratio of ``fr`` against each candidate
        keyframe: every candidate on the device, then one host read."""
        if not ids:
            return []
        fr_depth = self._frame_depth(fr)
        ratios = [self._matching(i, fr, fr_depth).relative_desc_inlier_ratio for i in ids]
        return torch.stack(ratios).cpu().tolist()

    def select_keyframe(self, frame_pose: SE3) -> int:
        """The reference keyframe: CLOSEST by pose distance over the active
        keyframes (ties go to the first), LAST or FIRST."""
        if self.cfg.tracking_mode == "LAST":
            return self.store.num_active - 1
        if self.cfg.tracking_mode == "FIRST":
            return 0
        n = self.store.num_active
        poses = self.store.variables.pose
        frame = SE3(frame_pose.rot.expand(n, 3, 3), frame_pose.trans.expand(n, 3))
        kcfg = self.cfg.keyframe
        dists = pose_distance(SE3(poses.rot[:n], poses.trans[:n]), frame,
                              kcfg.pose_dist_trans_weight, kcfg.pose_dist_rot_weight)
        return int(torch.argmin(dists))

    # ------------------------------------------------------------------

    def _reexpress_pose_ck(self, world_pose_guess: SE3, kf_id: int) -> SE3:
        """The camera-from-keyframe pose w.r.t. a new reference keyframe:
        tracking keeps ``world_pose_guess == pose(kf_id) o inverse(pose_ck)``,
        so ``pose_ck = inverse(world_pose_guess) o pose(kf_id)``."""
        return compose(inverse(world_pose_guess), self.store.pose(kf_id))

    def process_frame(self, timestamp: float, image=None,
                      frame: Optional[FrameData] = None) -> FrameResult:
        """Track one frame and decide whether it becomes a keyframe.
        ``frame`` passes a prebuilt frame (Mapper.build_frame's) in place of
        the image."""
        if self.store.num_active == 0:
            raise RuntimeError("call bootstrap() first")
        fr = frame if frame is not None else self.mapper.build_frame(timestamp, image)

        world_pose_guess = compose(self.store.pose(self.curr_kf), inverse(self.pose_ck))
        kf_id = self.select_keyframe(world_pose_guess)
        if kf_id != self.curr_kf:
            self.pose_ck = self._reexpress_pose_ck(world_pose_guess, kf_id)
            self.curr_kf = kf_id

        ref = self._tracker_ref(self.curr_kf)
        target = self._target(fr)
        # descriptor matching for the reprojection term and the ratios
        mg = self._match_geo(self.curr_kf, fr)
        cfgt = self.cfg.tracker
        terms = TrackTerms(
            reproj_dpts0=mg.dpts0,
            reproj_homo0=mg.homo0,
            reproj_matched_2d=mg.matched_2d_1,
            reproj_valid=mg.inliers,
            reproj_weight=mg.desc_inlier_ratio * cfgt.reproj_factor_weight,  # stays on the device
            reproj_loss_param=cfgt.reproj_loss_param_factor * self.cam.width**2,
        ) if cfgt.use_reprojection else TrackTerms()
        res = tracker.lm_track(self.pose_ck.rot, self.pose_ck.trans, ref, target, self.cam_pyr,
                               cfgt, terms=terms)
        self.pose_ck = SE3(res.rot, res.trans)
        self.last_track_iters, self.last_track_ref = res.iterations, self.curr_kf

        # metrics
        valid = self.mapper.valid_loc1d
        metrics = tracker.area_inlier_motion(
            self.store.depth_map(self.curr_kf)[valid], interp.locations_1d_to_homo(valid, self.cam),
            res.rot, res.trans, self.cam, self.mapper.mask_flat, cfgt.dpt_eps,
        )
        kf_pose = self.store.pose(self.curr_kf)
        frame_pose = compose(kf_pose, inverse(self.pose_ck))

        # ONE device->host read for every per-frame scalar and hull array
        nv = valid.shape[0]
        host = torch.cat([
            metrics["source_2d"].reshape(-1), metrics["warped_2d"].reshape(-1), metrics["within"],
            torch.stack([metrics["inlier_ratio"], metrics["average_motion"],
                         mg.relative_desc_inlier_ratio, res.error,
                         pose_distance(kf_pose, frame_pose, 1.0, 1.0)]),
        ]).cpu().numpy()
        src2d = host[: 2 * nv].reshape(nv, 2)
        warp2d = host[2 * nv : 4 * nv].reshape(nv, 2)
        within = host[4 * nv : 5 * nv] > 0.5
        inlier_ratio, avg_motion, desc_ratio, err, pose_dist = (float(x) for x in host[5 * nv :])
        a0 = tracker.convex_hull_area(src2d)
        a1 = tracker.convex_hull_area(warp2d[within]) if within.any() else 0.0
        area_ratio = a1 / a0 if a0 > 0 else 0.0

        fr.pose = frame_pose
        self.trajectory.append((timestamp, frame_pose))

        lost = (
            err > self.cfg.tracking_lost_min_error
            or area_ratio < self.cfg.tracking_lost_max_area_ratio
            or inlier_ratio < self.cfg.tracking_lost_max_inlier_ratio
        )
        new_kf = (not lost) and self._new_keyframe_required(
            area_ratio, inlier_ratio, avg_motion, desc_ratio
        )
        track_ref = (self.curr_kf, self.pose_ck)
        kf_created = self._create_keyframe(fr) if new_kf else -1
        with self.store.lock:
            if kf_created >= 0:
                # the frame IS a keyframe: its finalized pose is its own
                self.frame_refs.append((timestamp, kf_created, SE3.identity(device=self.device),
                                        self.store.variables.scale[kf_created].clone()))
            else:
                self.frame_refs.append((timestamp, track_ref[0], track_ref[1],
                                        self.store.variables.scale[track_ref[0]].clone()))

        if self.pose_callback is not None:
            self.pose_callback(timestamp, frame_pose)
        if self.stats_callback is not None:
            self.stats_callback(SlamStatistics(
                inlier_ratio=inlier_ratio, area_ratio=area_ratio, pose_distance=pose_dist,
                tracker_error=err, num_keyframes=self.store.num_active,
            ))
        return FrameResult(
            pose=frame_pose,
            tracked=True,
            new_keyframe=new_kf,
            keyframe_id=kf_created if new_kf else self.curr_kf,
            area_ratio=area_ratio,
            inlier_ratio=inlier_ratio,
            average_motion=avg_motion,
            desc_inlier_ratio=desc_ratio,
            tracker_error=err,
            tracking_lost=lost,
        )

    def _new_keyframe_required(self, area_ratio, inlier_ratio, avg_motion, desc_ratio) -> bool:
        if self.force_keyframe:
            self.force_keyframe = False
            return True
        if self.cfg.keyframe_mode == "NEVER":
            return False
        kcfg = self.cfg.keyframe
        frame_too_far = (
            area_ratio < kcfg.max_area_ratio
            or inlier_ratio < kcfg.max_inlier_ratio
            or avg_motion > kcfg.min_average_motion
        )
        return frame_too_far or desc_ratio < kcfg.max_desc_inlier_ratio

    def _create_keyframe(self, fr: FrameData) -> int:
        """Back connections: the reference keyframe, then the newest
        keyframes whose descriptor inlier ratio passes, up to
        temporal_max_back_connections; then the keyframe is enqueued."""
        kcfg = self.cfg.keyframe
        candidates = list(range(self.store.num_active - 1, -1, -1))[
            : kcfg.temporal_max_back_connections + 2
        ]
        back: List[int] = [self.curr_kf] if self.curr_kf in candidates else []
        pending = [c for c in candidates if c not in back]
        for cid, ratio in zip(pending, self._match_geo_ratios(pending, fr)):
            if len(back) >= kcfg.temporal_max_back_connections:
                break
            if ratio >= kcfg.temporal_min_desc_inlier_ratio:
                back.append(cid)
        if not back:
            back = [self.curr_kf]
        with self.store.lock:
            kf_id = self.mapper.enqueue_keyframe(fr, back)
            self.curr_kf = kf_id
            self.pose_ck = SE3.identity(device=self.device)
            self._visited.append(kf_id)
        return kf_id

    # ------------------------------------------------------------------
    # loop closure: the next slice

    def detect_local_loop(self, kf_id: int):
        raise NotImplementedError(LOOPS_NOT_PORTED)

    def detect_global_loop(self, kf_id: int):
        raise NotImplementedError(LOOPS_NOT_PORTED)

    def close_global_loops(self, kf_id: int, loops):
        raise NotImplementedError(LOOPS_NOT_PORTED)

    def local_loop_tick(self):
        raise NotImplementedError(LOOPS_NOT_PORTED)

    def global_loop_tick(self):
        raise NotImplementedError(LOOPS_NOT_PORTED)

    # ------------------------------------------------------------------

    def refine_mapping(self, iters: Optional[int] = None) -> float:
        """Final convergence loop: full-graph BA steps with every active
        keyframe free, until a full-weight step converges with no keyframe
        held. Records refine_iterations."""
        n = iters or self.cfg.mapper.refine_mapping_iters
        err = 0.0
        self.refine_iterations = 0
        mcfg = self.cfg.mapper
        coarse_w = None
        if mcfg.refine_coarse_rounds > 0:
            w = mcfg.photo_factor_weights
            coarse_w = tuple(0.0 if lvl < len(w) // 2 else w[lvl] for lvl in range(len(w)))
        for round_i in range(n):
            anneal = coarse_w if coarse_w is not None and round_i < mcfg.refine_coarse_rounds else None
            err = self.mapper.mapping_step(full=True, photo_weights=anneal)
            self.refine_iterations += self.mapper.last_step_iters
            # convergence at coarse weights is not convergence of the full cost
            if anneal is None and self.mapper.last_step_converged and not (
                self.store.reinitialize_count > 0
            ).any():
                break
        return err

    def keyframe_trajectory(self):
        """(timestamp, SE3) per keyframe."""
        with self.store.lock:
            return [(self.store.timestamps[i], _copy_pose(self.store.pose(i)))
                    for i in range(self.store.num_active)]

    def finalized_trajectory(self):
        """(timestamp, SE3) per frame, re-expressed from the current
        keyframe poses: pose = pose_wk o pose_kc(track), the relative
        translation rescaled by the keyframe's scale change since track
        time."""
        with self.store.lock:
            v = self.store.variables
            rot, trans = v.pose.rot.clone(), v.pose.trans.clone()
            scales = v.scale.cpu().tolist()
        s_track = torch.stack([s for *_, s in self.frame_refs]).cpu().tolist()
        out = []
        for (ts, ref, pose_ck, _), s_t in zip(self.frame_refs, s_track):
            q = scales[ref] / max(s_t, 1e-12)
            pose_kc = inverse(pose_ck)
            out.append((ts, compose(SE3(rot[ref], trans[ref]), SE3(pose_kc.rot, pose_kc.trans * q))))
        return out
