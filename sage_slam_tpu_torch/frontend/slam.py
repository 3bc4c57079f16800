"""SLAM orchestrator (port of sage_slam_tpu/frontend/slam.py).

* process_frame: build the frame, select the reference keyframe (CLOSEST
  by pose distance, or LAST / FIRST), descriptor matching and robust
  registration against it, 6-DoF LM tracking (photometric + reprojection),
  the keyframe decision on the area / inlier / motion / descriptor ratios,
  and keyframe creation with back connections gated by the descriptor
  inlier ratio; the keyframe's BoW vector is added in the same locked step
  that makes the keyframe visible;
* loop closure: a local loop (a keyframe tracked in 7 DoF against older
  ones in its visited window, gated against a baseline track) adds a link;
  a global loop (BoW query, 7-DoF verification with a cycle check and a
  metric re-fit of |t|) solves the pose-scale graph (loop/pose_graph.py),
  writes it back and adds a link; ``local_loop_tick`` / ``global_loop_tick``
  search the newest keyframe each backend has not searched yet;
* mapping: the caller (or frontend/driver.py's mapping thread) runs
  ``mapper.mapping_step()`` after each new keyframe, and ``refine_mapping``
  at the end.

Host reads per frame: one for the reference keyframe's argmin, the
tracker's (see tracker/tracker.py), one batched read of every per-frame
metric, and on a keyframe frame one for the candidates' ratios and one for
the depth-scale median (Mapper.correct_depth_scale).

The store is written in place, so everything kept across frames (the
trajectory's poses, the frame references' poses and scales) is a copy,
never a view of a store row. The pose-scale graph is built from a clone of
the variables taken under the store lock, solved with the lock released,
and written back row by row under the lock. Every thread issues its work on
the default CUDA stream, so a kernel launched under the lock reads the
rows as they stood then, whatever a later launch writes.
"""

from __future__ import annotations

import copy
import dataclasses
import logging
from typing import Callable, List, Optional

import numpy as np
import torch

from ..config import SlamConfig
from ..device import resolve_device
from ..geometry import interp
from ..geometry.camera import CameraPyramid, PinholeCamera
from ..geometry.se3 import SE3, compose, inverse, pose_distance
from ..loop import pose_graph, vocabulary
from ..mapping.keyframe_store import FrameData
from ..mapping.mapper import Mapper
from ..tracker import tracker
from ..tracker.matching_geo import MatchGeoResult, feature_matching_geo
from ..tracker.tracker import TrackerRef, TrackerTarget, TrackTerms
from ..utils import timing

# enable with logging.getLogger("sage_slam").setLevel(logging.DEBUG)
log = logging.getLogger("sage_slam.loop")


@dataclasses.dataclass
class LoopInfo:
    detected: bool = False
    id_ref: int = -1
    pose_cur_ref: Optional[SE3] = None
    query_scale: float = 1.0
    ref_scale: float = 1.0
    desc_inlier_ratio: float = 0.0
    # verification quality in (0, 1]: 1 - the worst normalised cycle
    # residual of the two-way 7-DoF check (1.0 without the cycle gate);
    # scales the loop edge's pose-graph weight
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
        voc: Optional[vocabulary.Vocabulary] = None,
        video_mask_in=None,  # [H, W] input-resolution mask for the networks
        device=None,
    ):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.cam = camera
        self.cam_pyr = CameraPyramid.build(camera, cfg.pyramid_levels)
        self.mapper = Mapper(cfg, self.cam_pyr, video_mask, depth_net, feat_net,
                             video_mask_in=video_mask_in, device=self.device)
        self.store = self.mapper.store
        self.voc = None if voc is None else voc.to(self.device)
        self.bow_db = None if voc is None else vocabulary.BowDatabase(self.voc, cfg.max_keyframes)
        self.curr_kf: int = -1
        self.pose_ck: SE3 = SE3.identity(device=self.device)  # camera-from-keyframe
        self.trajectory: List[tuple] = []  # (ts, SE3 world-from-camera), as tracked
        # per frame (ts, ref_kf, pose_ck, ref scale at track time): enough to
        # re-express every frame pose from the final keyframe poses
        # (finalized_trajectory)
        self.frame_refs: List[tuple] = []
        self.global_loops: dict = {}  # (id0, id1) -> (scale0, scale1) at the loop
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
        # injection point: called after the pose-scale graph's snapshot (lock
        # released) and before its solve, so a keyframe can land mid-solve
        self._loop_solve_hook: Optional[Callable] = None
        # telemetry of the loop methods: the LM iterations of every 7-DoF
        # track, every global-loop candidate stopped at a gate as (query,
        # reference, gate, value, limit), and the last pose-scale solve's
        # iterations, edges and error
        self.loop_track_iters: List[int] = []
        self.loop_rejections: List[tuple] = []
        self.last_pose_graph: dict = {}

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
        out.loop_track_iters = list(self.loop_track_iters)
        out.loop_rejections = list(self.loop_rejections)
        out.last_pose_graph = dict(self.last_pose_graph)
        if self.bow_db is not None:
            out.voc = self.voc.to(dev)
            out.bow_db = vocabulary.BowDatabase(out.voc, self.bow_db.capacity)
            with self.store.lock:
                out.bow_db.vectors = to(self.bow_db.vectors)
                out.bow_db.count = self.bow_db.count
        return out

    # ------------------------------------------------------------------

    def bootstrap(self, timestamp: float, image=None, frame: Optional[FrameData] = None) -> int:
        """The first keyframe; ``frame`` passes a prebuilt frame."""
        with self.store.lock:
            kf_id = self.mapper.init_one_frame(timestamp, image, frame=frame)
            self.curr_kf = kf_id
            self.pose_ck = SE3.identity(device=self.device)
            self._visited.append(kf_id)
            self._add_bow(self.store.row("feat_desc", kf_id))
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
            tables=fr.tables,
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
        with timing.span("tracker.convex_hull_area"):
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

    @timing.span("slam.create_keyframe")
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
        # the loop backends key off store.num_active, so the BoW vector is
        # added in the same locked step that makes the keyframe visible
        with self.store.lock:
            kf_id = self.mapper.enqueue_keyframe(fr, back)
            self.curr_kf = kf_id
            self.pose_ck = SE3.identity(device=self.device)
            self._visited.append(kf_id)
            self._add_bow(fr.feat_desc_flat)
        return kf_id

    def _add_bow(self, feat_desc_flat):
        """The keyframe's BoW vector over the mask's valid pixels (call
        under store.lock)."""
        if self.bow_db is not None:
            self.bow_db.add(feat_desc_flat[self.mapper.valid_loc1d])

    # ------------------------------------------------------------------
    # loop closure

    def _reject(self, query: Optional[int], ref: int, gate: str, value, limit) -> None:
        """Record (and log) a global-loop candidate stopped at ``gate``."""
        self.loop_rejections.append((query, ref, gate, value, limit))
        log.debug("global_loop kf=%s cand=%d REJECT %s %s (limit %s)", query, ref, gate, value, limit)

    def _loop_scan_metrics(self, kf_id: int):
        """Pose distance and BoW score of keyframe kf_id against every store
        row (the full capacity), in one host read -> (dists [K], sims [K])."""
        kcap = self.store.capacity
        with self.store.lock:
            rot, trans = self.store.variables.pose
            kf = SE3(rot[kf_id].expand(kcap, 3, 3), trans[kf_id].expand(kcap, 3))
            dists = pose_distance(kf, SE3(rot, trans), 1.0, 1.0)
        if self.bow_db is not None:
            vecs = self.bow_db.vectors
            sims = vocabulary.score_l1(vecs[kf_id], vecs)
        else:
            sims = torch.ones_like(dists)
        host = torch.stack([dists, sims]).cpu().numpy()
        return host[0], host[1]

    @timing.span("detect_local_loop")
    def detect_local_loop(self, kf_id: int) -> LoopInfo:
        """Local loop: candidates in the visited window are verified by
        7-DoF tracking and gated on area x inlier, descriptor, BoW and
        motion metrics against a baseline, the keyframe tracked against its
        CLOSEST temporal connection."""
        lcfg = self.cfg.loop
        conns = self.store.connections(kf_id, temporal_only=True)
        if not conns:
            return LoopInfo()
        dists_all, sims_all = self._loop_scan_metrics(kf_id)
        min_i = int(np.argmin([dists_all[c] for c in conns]))
        min_id, min_dist = conns[min_i], float(dists_all[conns[min_i]])

        fr_like = self._store_frame_view(kf_id)
        base = self._track_7dof(min_id, fr_like, self._match_geo(min_id, fr_like))
        if base is None:
            return LoopInfo()
        r = lcfg.local_metric_ratio
        best_metric = r * base["area_ratio"] * base["inlier_ratio"]
        best_desc = r * base["desc_ratio"]
        best_sim = r * float(sims_all[min_id]) if self.bow_db is not None else 0.0
        best_motion = base["average_motion"] / r
        ref_dist = lcfg.local_dist_ratio * min_dist

        # scan the visited ids backwards from this keyframe; every examined
        # entry counts toward the window
        try:
            start = len(self._visited) - 1 - self._visited[::-1].index(kf_id)
        except ValueError:
            start = len(self._visited) - 1
        best_id = -1
        examined = 0
        idx = start - 1
        while examined < lcfg.local_active_window and idx >= 0:
            cid = self._visited[idx]
            idx -= 1
            examined += 1
            if abs(cid - kf_id) <= self.cfg.keyframe.temporal_max_back_connections:
                continue
            if self.store.link_exists(kf_id, cid):
                continue
            if float(dists_all[cid]) >= ref_dist:
                continue
            # descriptor pre-check before the track
            mg = self._match_geo(cid, fr_like)
            desc_ratio = float(mg.desc_inlier_ratio)
            if desc_ratio < lcfg.min_desc_inlier_ratio or desc_ratio < best_desc:
                continue
            m = self._track_7dof(cid, fr_like, mg)
            if m is None:
                continue
            if m["area_ratio"] < lcfg.min_area_ratio or m["inlier_ratio"] < lcfg.min_inlier_ratio:
                continue
            metric = m["area_ratio"] * m["inlier_ratio"]
            sim = float(sims_all[cid]) if self.bow_db is not None else 1.0
            motion = m["average_motion"]
            if (metric > best_metric and desc_ratio > best_desc and motion < best_motion
                    and (self.bow_db is None or sim > best_sim)):
                best_metric, best_desc, best_sim, best_motion, best_id = metric, desc_ratio, sim, motion, cid
        if best_id == -1:
            return LoopInfo()
        return LoopInfo(detected=True, id_ref=best_id, desc_inlier_ratio=best_desc)

    def _store_frame_view(self, kf_id: int) -> FrameData:
        """A FrameData over a stored keyframe (for re-matching and
        tracking): views of its rows, which are never rewritten, and copies
        of its variables, which are."""
        st = self.store
        with st.lock:
            pose = _copy_pose(st.pose(kf_id))
            code = st.variables.code[kf_id].clone()
            scale = st.variables.scale[kf_id].clone()
        return FrameData(
            timestamp=st.timestamps[kf_id], bias_flat=st.row("bias_flat", kf_id),
            jac_flat=st.row("jac_flat", kf_id), feat_pyr=st.row("feat_pyr", kf_id),
            grad_pyr=st.row("grad_pyr", kf_id), feat_desc_flat=st.row("feat_desc", kf_id),
            src_feats=st.row("src_feats", kf_id), loc1d=st.row("loc1d", kf_id),
            homo=st.row("homo", kf_id), avg_sq_bias=st.row("avg_sq_bias", kf_id), pose=pose,
            code=code, scale=float(scale),
            tables=None if st.tables is None else st.tables.rows(kf_id),
        )

    def _global_candidates(self, kf_id: int, scores, ids, max_sim: float) -> List[int]:
        """The BoW query's candidates for a global loop: outside the active
        window, at or above global_sim_ratio times the best temporal
        neighbour's score (the scores come sorted descending, so the scan
        stops at the first one below), and not linked yet."""
        lcfg = self.cfg.loop
        out = []
        for s, cid in zip(scores, ids):
            cid = int(cid)
            if abs(cid - kf_id) < lcfg.global_active_window:
                continue
            if s < lcfg.global_sim_ratio * max_sim:
                if s > vocabulary.EMPTY_SCORE:  # else the list of stored rows ended
                    self._reject(kf_id, cid, "sim", float(s), lcfg.global_sim_ratio * max_sim)
                break
            if self.store.link_exists(kf_id, cid):
                continue
            out.append(cid)
        return out

    @timing.span("detect_global_loop")
    def detect_global_loop(self, kf_id: int) -> List[LoopInfo]:
        """Global loop: BoW query, gates, 7-DoF verification of each
        candidate, then redundancy suppression."""
        if self.bow_db is None:
            return []
        lcfg = self.cfg.loop
        conns = self.store.connections(kf_id)
        # one host read: the top-k and the temporal neighbours' best score
        scores, ids, max_sim = self.bow_db.query(self.bow_db.vectors[kf_id], lcfg.max_candidates,
                                                 conn_ids=conns)
        candidates = self._global_candidates(kf_id, scores, ids, max_sim)
        log.debug("global_loop kf=%d max_temporal_sim=%.3f candidates=%s", kf_id, max_sim, candidates)
        if not candidates:
            return []
        fr_like = self._store_frame_view(kf_id)
        loops: List[LoopInfo] = []
        for cid in sorted(candidates):
            mg = self._match_geo(cid, fr_like)
            ratio = float(mg.desc_inlier_ratio)
            if ratio < lcfg.min_desc_inlier_ratio:
                self._reject(kf_id, cid, "desc_ratio", ratio, lcfg.min_desc_inlier_ratio)
                continue
            verified = self._verify_loop_7dof(cid, fr_like, mg, query_id=kf_id)
            if verified is not None:
                verified.desc_inlier_ratio = ratio
                loops.append(verified)
                log.debug("global_loop kf=%d cand=%d ACCEPT", kf_id, cid)
        # redundancy suppression
        loops.sort(key=lambda lp: -lp.desc_inlier_ratio)
        filtered: List[LoopInfo] = []
        for lp in loops:
            if all(abs(lp.id_ref - q.id_ref) >= lcfg.global_redundant_range for q in filtered):
                filtered.append(lp)
        return filtered

    @timing.span("track_7dof")
    def _track_7dof(self, ref_id, fr_like: FrameData, mg: MatchGeoResult) -> Optional[dict]:
        """7-DoF LM tracking of ``fr_like`` against keyframe ``ref_id`` with
        the match-geometry term, at the loop's own LM settings, and the
        convex-hull overlap metrics. None below 3 registration inliers."""
        cfgt, lcfg = self.cfg.tracker, self.cfg.loop
        n_inl, desc_ratio, avg_sq_bias = torch.stack([
            torch.sum(mg.inliers), mg.desc_inlier_ratio, self.store.avg_sq_bias[ref_id],
        ]).cpu().tolist()
        if n_inl < 3:
            return None
        terms = TrackTerms(
            mg_dpts0=mg.dpts0, mg_homo0=mg.homo0, mg_dpts1=mg.dpts1, mg_homo1=mg.homo1,
            mg_valid=mg.inliers, mg_weight=desc_ratio * cfgt.match_geom_factor_weight,
            mg_loss_param=cfgt.match_geom_loss_param_factor * avg_sq_bias,
        )
        loop_tcfg = dataclasses.replace(
            cfgt, max_num_iters=lcfg.tracking_max_num_iters,
            min_grad_thresh=lcfg.tracking_min_grad_thresh,
            min_param_inc_thresh=lcfg.tracking_min_param_inc_thresh,
            damp_dec_factor=lcfg.tracking_damp_dec_factor, damp_inc_factor=lcfg.tracking_damp_inc_factor,
        )
        res = tracker.lm_track(mg.guess_rot, mg.guess_trans, self._tracker_ref(ref_id), self._target(fr_like),
                               self.cam_pyr, loop_tcfg, terms=terms, with_scale=True,
                               init_scale=mg.guess_scale)
        self.loop_track_iters.append(res.iterations)
        valid = self.mapper.valid_loc1d
        metrics = tracker.area_inlier_motion(
            self.store.depth_map(ref_id)[valid], interp.locations_1d_to_homo(valid, self.cam),
            res.rot, res.trans, self.cam, self.mapper.mask_flat, cfgt.dpt_eps,
        )
        nv = valid.shape[0]
        host = torch.cat([
            metrics["source_2d"].reshape(-1), metrics["warped_2d"].reshape(-1), metrics["within"],
            torch.stack([metrics["inlier_ratio"], metrics["average_motion"]]),
        ]).cpu().numpy()
        within = host[4 * nv : 5 * nv] > 0.5
        a0 = tracker.convex_hull_area(host[: 2 * nv].reshape(nv, 2))
        warp2d = host[2 * nv : 4 * nv].reshape(nv, 2)
        a1 = tracker.convex_hull_area(warp2d[within]) if within.any() else 0.0
        return dict(res=res, area_ratio=a1 / a0 if a0 > 0 else 0.0, inlier_ratio=float(host[5 * nv]),
                    average_motion=float(host[5 * nv + 1]), desc_ratio=desc_ratio)

    @timing.span("verify_loop_7dof")
    def _verify_loop_7dof(self, ref_id, fr_like: FrameData, mg: MatchGeoResult,
                          query_id: Optional[int] = None) -> Optional[LoopInfo]:
        """7-DoF verification of a loop candidate: the track's overlap gates,
        the two-way cycle check, and the metric re-fit of |t| (float64
        least squares on host values)."""
        lcfg = self.cfg.loop
        m = self._track_7dof(ref_id, fr_like, mg)
        if m is None:
            self._reject(query_id, ref_id, "matches", None, 3)
            return None
        res = m["res"]
        if m["area_ratio"] < lcfg.min_area_ratio:
            self._reject(query_id, ref_id, "area_ratio", m["area_ratio"], lcfg.min_area_ratio)
            return None
        if m["inlier_ratio"] < lcfg.min_inlier_ratio:
            self._reject(query_id, ref_id, "inlier_ratio", m["inlier_ratio"], lcfg.min_inlier_ratio)
            return None
        quality = 1.0
        if lcfg.verify_cycle and query_id is not None:
            # the reference tracked against the query must compose with the
            # forward track to about the identity
            ref_like = self._store_frame_view(ref_id)
            m_rev = self._track_7dof(query_id, ref_like, self._match_geo(query_id, ref_like))
            if m_rev is None:
                self._reject(query_id, ref_id, "reverse matches", None, 3)
                return None
            rr = m_rev["res"]
            h = torch.cat([res.rot.reshape(-1), res.trans, rr.rot.reshape(-1), rr.trans]).cpu().numpy()
            rot_f, t_f, rot_r, t_r = h[:9].reshape(3, 3), h[9:12], h[12:21].reshape(3, 3), h[21:24]
            ang = np.degrees(np.arccos(np.clip((np.trace(rot_f @ rot_r) - 1) / 2, -1, 1)))
            cyc_t_norm = float(np.linalg.norm(rot_f @ t_r + t_f))
            t_mag = 0.5 * (float(np.linalg.norm(t_f)) + float(np.linalg.norm(t_r)))
            t_thresh = max(lcfg.cycle_trans_floor, lcfg.cycle_max_trans_ratio * t_mag)
            if ang > lcfg.cycle_max_rot_deg:
                self._reject(query_id, ref_id, "cycle rot deg", float(ang), lcfg.cycle_max_rot_deg)
                return None
            if cyc_t_norm > t_thresh:
                self._reject(query_id, ref_id, "cycle trans", cyc_t_norm, t_thresh)
                return None
            quality = float(np.clip(1.0 - max(float(ang) / lcfg.cycle_max_rot_deg, cyc_t_norm / t_thresh),
                                    0.25, 1.0))

        res_trans = res.trans
        if lcfg.verify_metric_trans:
            # with R fixed, min_{a,t} sum |x1 - a R x0 - t|^2 is linear
            # (A_i = [R x0_i | I3], b_i = x1_i); its t carries the depth
            # maps' metric scale
            k = mg.dpts0.shape[0]
            h = torch.cat([mg.dpts0, mg.homo0.reshape(-1), mg.dpts1, mg.homo1.reshape(-1),
                           mg.inliers.to(mg.dpts0.dtype), res.rot.reshape(-1), res.trans]).cpu().numpy()
            d0, h0 = h[:k], h[k : 4 * k].reshape(k, 3)
            d1, h1 = h[4 * k : 5 * k], h[5 * k : 8 * k].reshape(k, 3)
            w_in = h[8 * k : 9 * k] > 0.5
            rot, trans = h[9 * k : 9 * k + 9].reshape(3, 3), h[9 * k + 9 :]
            n_in = int(w_in.sum())
            if n_in < lcfg.verify_metric_min_inliers:
                self._reject(query_id, ref_id, "metric inliers", n_in, lcfg.verify_metric_min_inliers)
                return None
            x0 = (d0[:, None] * h0)[w_in]
            x1 = (d1[:, None] * h1)[w_in]
            a_mat = np.zeros((3 * n_in, 4))
            a_mat[:, 0] = (x0 @ rot.T).reshape(-1)
            a_mat[:, 1:] = np.tile(np.eye(3), (n_in, 1))
            sol, *_ = np.linalg.lstsq(a_mat, x1.reshape(-1), rcond=None)
            t_ls = sol[1:4]
            mag_lm = float(np.linalg.norm(trans))
            mag_ls = float(np.linalg.norm(t_ls))
            med_d = float(np.median(d0[w_in]))
            if lcfg.global_max_baseline_ratio > 0 and mag_ls > lcfg.global_max_baseline_ratio * med_d:
                # not a revisit
                self._reject(query_id, ref_id, "baseline", mag_ls, lcfg.global_max_baseline_ratio * med_d)
                return None
            cos = float(trans @ t_ls / max(mag_lm * mag_ls, 1e-12))
            ratio = mag_lm / max(mag_ls, 1e-12)
            if ratio > lcfg.verify_metric_max_ratio or ratio < 1.0 / lcfg.verify_metric_max_ratio:
                self._reject(query_id, ref_id, "metric |t| ratio", ratio, lcfg.verify_metric_max_ratio)
                return None
            if cos < lcfg.verify_metric_min_cos:
                self._reject(query_id, ref_id, "metric cos", cos, lcfg.verify_metric_min_cos)
                return None
            # keep the photometric direction, pin the metric magnitude; the
            # translation is already in the query's store units (the tracker
            # models scaled store depths)
            res_trans = res.trans * (mag_ls / max(mag_lm, 1e-12))
            log.debug("verify_7dof ref=%d metric |t_lm|=%.4f |t_ls|=%.4f a_ls=%.3f cos=%.3f", ref_id,
                      mag_lm, mag_ls, float(sol[0]), cos)

        ref_scale = float(self.store.variables.scale[ref_id])
        if lcfg.verify_metric_trans:
            trans = res_trans
        else:
            # the reference's conversion (loop_detector.cpp:188-196)
            trans = res_trans * ref_scale / float(res.scale)
        pose_cur_ref = SE3(res.rot, trans)
        fr_scale = self.mapper.correct_depth_scale(
            dataclasses.replace(fr_like, pose=compose(self.store.pose(ref_id), inverse(pose_cur_ref))), ref_id,
        )
        return LoopInfo(detected=True, id_ref=ref_id, pose_cur_ref=pose_cur_ref, query_scale=fr_scale,
                        ref_scale=ref_scale, quality=quality)

    @timing.span("close_global_loops")
    def close_global_loops(self, kf_id: int, loops: List[LoopInfo]):
        """Pose-scale graph solve and write-back.

        The graph is built from a clone of the variables taken under the
        store lock, solved with the lock released (the frontend keeps
        tracking), and written back under the lock: rows [0, n) of the
        graph take the solve's values, keyframes created during the solve
        are propagated rigidly from the last in-graph keyframe (their
        current poses and its pre-update pose and scale are read before any
        row is written), and every touched row bumps reinitialize_count
        and version, so a concurrent mapping merge keeps the loop's values."""
        if not loops:
            return
        lcfg = self.cfg.loop
        k = self.store.capacity
        dev = self.device
        # forward edges (a, b, scale0, scale1, weight, loop); each is followed
        # by its reverse. Targets: the snapshot's relative pose, or a new
        # loop's verified pose_cur_ref
        fwd: List[tuple] = []
        new_rels: List[SE3] = []
        in_graph = set()
        scale_valid = np.zeros(k, np.float32)
        scale_target = np.ones(k, np.float32)
        scale_weight = np.full(k, lcfg.pose_graph_scale_prior_weight, np.float32)
        with self.store.lock:
            n = self.store.num_active
            _, _, snap = self.store.snapshot()
            scales = snap.scale[:n].cpu().numpy()
            for a in range(n):
                for b in self.store.connections(a):
                    if b < n and a < b and (a, b) not in self.global_loops:
                        fwd.append((a, b, scales[a], scales[b], lcfg.pose_graph_local_link_weight, 0.0))
                        in_graph.update((a, b))
            for (a, b), (s0, s1) in self.global_loops.items():
                fwd.append((a, b, s0, s1, lcfg.pose_graph_global_link_weight, 1.0))
                in_graph.update((a, b))
            n_snap_edges = len(fwd)
            tgt_s0 = loops[0].ref_scale
            for idx, lp in enumerate(loops):
                tgt_s1 = tgt_s0 * lp.query_scale / lp.ref_scale
                # ref -> query: the factor's T_q^-1 T_ref is pose_cur_ref; the
                # weight scaled by the verification quality
                fwd.append((lp.id_ref, kf_id, tgt_s0, tgt_s1, lcfg.pose_graph_global_link_weight * lp.quality,
                            1.0))
                new_rels.append(lp.pose_cur_ref)
                in_graph.update((lp.id_ref, kf_id))
                if idx == 0:
                    scale_valid[[lp.id_ref, kf_id]] = 1.0
                    scale_target[lp.id_ref], scale_target[kf_id] = tgt_s0, tgt_s1
                self.global_loops[(min(lp.id_ref, kf_id), max(lp.id_ref, kf_id))] = (tgt_s0, tgt_s1)
                self.store.add_link(lp.id_ref, kf_id, global_loop=True)
                self.mapper.enqueue_link(kf_id, lp.id_ref, True, lcfg.use_match_geom,
                                         self.cfg.mapper.use_geometric, True)
            # anchor the first keyframe
            scale_valid[0] = 1.0
            scale_target[0] = scales[0]
            scale_weight[0] = 100.0

        def t(values, dtype=torch.float32):
            return torch.as_tensor(np.asarray(values), dtype=dtype, device=dev)

        p = snap.pose
        a_idx = t([e[0] for e in fwd[:n_snap_edges]], torch.int64)
        b_idx = t([e[1] for e in fwd[:n_snap_edges]], torch.int64)
        rel = compose(inverse(SE3(p.rot[b_idx], p.trans[b_idx])), SE3(p.rot[a_idx], p.trans[a_idx]))
        rel = SE3(torch.cat([rel.rot, *(r.rot[None] for r in new_rels)]),
                  torch.cat([rel.trans, *(r.trans[None] for r in new_rels)]))
        rev = inverse(rel)
        both = lambda x, y: torch.stack([x, y], dim=1).reshape(-1, *x.shape[1:])  # noqa: E731
        pair = lambda i, j: [x for e in fwd for x in (e[i], e[j])]  # noqa: E731
        is_loop = pair(5, 5)
        edges = pose_graph.PoseScaleEdges(
            i0=t(pair(0, 1), torch.int64), i1=t(pair(1, 0), torch.int64),
            target_rot=both(rel.rot, rev.rot), target_trans=both(rel.trans, rev.trans),
            target_scale0=t(pair(2, 3)), target_scale1=t(pair(3, 2)), weight=t(pair(4, 4)),
            valid=torch.ones(2 * len(fwd), device=dev), is_loop=t(is_loop),
        )
        pose_valid = np.zeros(k, np.float32)
        pose_valid[0] = 1.0
        priors = pose_graph.PoseScalePriors(
            pose_valid=t(pose_valid), pose_target=snap.pose, pose_weight=1.0e8,
            scale_valid=t(scale_valid), scale_target=t(scale_target), scale_weight=t(scale_weight),
        )
        variables = pose_graph.make_pose_scale_variables(snap.pose, snap.scale)
        active = np.zeros(k, np.float32)
        active[:n] = 1.0

        # robust loop edges: the Geman-McClure phi follows the odometry
        # edges' residual scale at the snapshot
        dcs_phi = 0.0
        if lcfg.pose_graph_dcs_factor > 0:
            edge_err = pose_graph._edge_linearize(variables, edges, lcfg)[2].cpu().numpy()
            odo = edge_err[np.asarray(is_loop) < 0.5]
            if len(odo):
                dcs_phi = float(lcfg.pose_graph_dcs_factor * max(float(np.median(odo)), 1e-8))

        if self._loop_solve_hook is not None:
            self._loop_solve_hook()
        v_opt, err, iters = pose_graph.optimize(variables, edges, priors, lcfg, t(active), dcs_phi=dcs_phi)
        self.last_pose_graph = dict(iterations=iters, edges=2 * len(fwd), error=float(err), dcs_phi=dcs_phi)

        with self.store.lock:
            v = self.store.variables
            newer = list(range(n, self.store.num_active))
            prop = {}
            if newer and in_graph:
                # every value it needs is read here, before a row is written
                prop = pose_graph.propagate_newer_keyframes(
                    SE3(v.pose.rot, v.pose.trans), v.scale, v_opt.pose, v_opt.scale, max(in_graph), newer,
                )
            v.pose.rot[:n] = v_opt.pose.rot[:n]
            v.pose.trans[:n] = v_opt.pose.trans[:n]
            v.scale[:n] = v_opt.scale[:n]
            for i, (pose_i, scale_i) in prop.items():
                v.pose.rot[i], v.pose.trans[i], v.scale[i] = pose_i.rot, pose_i.trans, scale_i
            touched = list(in_graph | {kf_id}) + newer
            self.store.reinitialize_count[touched] += 1
            self.store.version[touched] += 1

    # ------------------------------------------------------------------
    # loop-backend scheduling: each tick picks the NEWEST keyframe its
    # backend has not searched, marks it and runs detection, so every
    # keyframe is searched even when keyframes come faster than the ticks

    def _newest_unsearched(self, flags) -> Optional[int]:
        for i in range(self.store.num_active - 1, -1, -1):
            if not flags[i]:
                return i
        return None

    def local_loop_tick(self) -> Optional[LoopInfo]:
        """One local-loop backend iteration: detect on the newest unsearched
        keyframe and enqueue a loop link (photometric, reprojection and
        geometric factors as the mapper is configured)."""
        if not self.cfg.loop.use_local_loop:
            return None
        kf_id = self._newest_unsearched(self.store.local_loop_searched)
        if kf_id is None:
            return None
        self.store.local_loop_searched[kf_id] = True
        info = self.detect_local_loop(kf_id)
        if info.detected:
            m = self.cfg.mapper
            self.mapper.enqueue_link(kf_id, info.id_ref, m.use_photometric, m.use_reprojection,
                                     m.use_geometric, False)
        return info

    def global_loop_tick(self) -> List[LoopInfo]:
        """One global-loop backend iteration: BoW detection on the newest
        unsearched keyframe, then the pose-scale solve."""
        if not self.cfg.loop.use_global_loop or self.bow_db is None:
            return []
        kf_id = self._newest_unsearched(self.store.global_loop_searched)
        if kf_id is None:
            return []
        self.store.global_loop_searched[kf_id] = True
        loops = self.detect_global_loop(kf_id)
        if loops:
            self.close_global_loops(kf_id, loops)
        return loops

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
        if not self.frame_refs:
            return []
        s_track = torch.stack([s for *_, s in self.frame_refs]).cpu().tolist()
        out = []
        for (ts, ref, pose_ck, _), s_t in zip(self.frame_refs, s_track):
            q = scales[ref] / max(s_t, 1e-12)
            pose_kc = inverse(pose_ck)
            out.append((ts, compose(SE3(rot[ref], trans[ref]), SE3(pose_kc.rot, pose_kc.trans * q))))
        return out
