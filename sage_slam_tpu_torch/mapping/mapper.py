"""Mapper: keyframe lifecycle and the windowed BA (port of
sage_slam_tpu/mapping/mapper.py).

* build_frame: feature and depth networks, Gaussian feature pyramid with
  gradients, seeded photometric sampling, the frame's sampling tables and
  its masked mean squared depth bias,
* init_one_frame: median-depth normalization and the first keyframe's
  priors,
* enqueue_keyframe: depth-scale correction against the first
  back-connection, photometric (+reprojection) + geometric factors both
  ways per connection; enqueue_frame (pose-only aux frames) and
  enqueue_link (loop links),
* mapping_step: one windowed damped-GN solve over the keyframes incident to
  the window's edges (the compact step), merged back into the store; with
  ``mesh=`` the same selection, snapshot, merge and edge retirement around
  an edge-sharded solve at the store's full capacity (parallel/sharded_ba).

Differences from the JAX package:

* Sampling. The JAX package draws ``loc1d`` and reprojection keypoints with
  ``jax.random.permutation``, which torch cannot reproduce; the port draws
  them with ``torch.randperm`` on a CPU generator seeded from the same
  integer (so the card and the CPU draw the same ids), and build_frame,
  init_one_frame and _add_reproj_edge accept injected ids.
* Edge tables are built at the live edge count. The JAX package pads them
  to geometric buckets of 128 only to bound XLA recompiles; padded rows
  carry valid=0 and add exact zeros, so nothing else changes. The compact
  keyframe padding (kc) is kept: it fixes the rows the solve sees.
* Snapshots. The store writes rows in place, so mapping_step clones the
  variables and gathers the compact window under the store lock, then
  solves with the lock released.
* The sharded step (``mesh=``) honours ``photo_weights``: the JAX package
  asserts ``photo_weights is None`` there (mapper.py:721), so its
  coarse-to-fine refine cannot run on a mesh; the port passes the
  overridden MapperConfig to the sharded solve as the unsharded step does.
"""

from __future__ import annotations

import copy
import dataclasses
import logging
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import SlamConfig
from ..device import resolve_device, set_f32_precision
from ..geometry import interp
from ..geometry.camera import CameraPyramid
from ..geometry.se3 import SE3, relative_pose
from ..models import depth_network, feature_network
from ..ops import photometric
from ..ops.pyramid import gaussian_pyramid_with_grad, mask_pyramid
from ..solver import ba
from ..solver.graph import Variables
from ..tracker import matcher, robust
from ..utils import timing
from .keyframe_store import FrameData, KeyframeStore


def _round_up(n: int, m: int) -> int:
    """n rounded up to a geometric bucket m, 2m, 4m, ..."""
    cap = m
    while cap < n:
        cap *= 2
    return cap


def median(x: torch.Tensor) -> torch.Tensor:
    """jnp.median: the midpoint of the two middle order statistics (torch.
    median returns the lower one for an even count)."""
    s = torch.sort(x.reshape(-1)).values
    n = s.shape[0]
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


def sample_seed(timestamp: float) -> int:
    """The per-frame sampling seed of the JAX package's build_frame."""
    return int(timestamp * 1e6) & 0x7FFFFFFF


class Mapper:
    def __init__(
        self,
        cfg: SlamConfig,
        cam_pyr: CameraPyramid,
        video_mask,  # [h, w] output-resolution mask
        depth_net: depth_network.DepthNetwork,
        feat_net: feature_network.FeatureNetwork,
        video_mask_in=None,  # [H, W] input-resolution mask for the networks
        device=None,
    ):
        self.device = dev = resolve_device(device)
        self.cfg = cfg
        self.cam_pyr = cam_pyr
        self.mask = torch.as_tensor(np.asarray(video_mask, np.float32), device=dev)
        self.mask_flat = self.mask.reshape(-1)
        # None: the networks see an all-ones mask (standard convolutions)
        self.mask_in = (
            None if video_mask_in is None
            else torch.as_tensor(np.asarray(video_mask_in, np.float32), device=dev)
        )
        self.depth_net = depth_net.to(dev)
        self.feat_net = feat_net.to(dev)
        h, w = self.mask.shape
        valid = np.flatnonzero(np.asarray(video_mask, np.float32).reshape(-1) > 0.5)
        self.valid_loc1d = torch.as_tensor(valid.astype(np.int64), device=dev)
        # sampling is without replacement, so it never exceeds the mask
        self.num_samples = min(cfg.mapper.pho_num_samples, len(valid))
        if self.num_samples < cfg.mapper.pho_num_samples:
            logging.getLogger("sage_slam").info(
                "pho_num_samples %d clamped to %d valid mask pixels",
                cfg.mapper.pho_num_samples, self.num_samples,
            )
        self.store = KeyframeStore(
            capacity=cfg.max_keyframes, num_samples=self.num_samples, hw=h * w,
            cs=cfg.code_size, fs=cfg.feat_size, total_pyr=cam_pyr.total_pixels,
            levels=cam_pyr.levels, device=dev,
        )
        self.masks_pyr = mask_pyramid(self.mask, cam_pyr.levels)

        # host edge lists with parallel per-edge iteration budgets: an edge
        # is linearized for at most cfg.mapper.factor_iters LM iterations,
        # then retired
        self.photo_edges: List[Tuple[int, int]] = []
        self.geo_edges: List[Tuple[int, int]] = []
        self.reproj_edges: List[dict] = []
        self.photo_edge_iters: List[int] = []
        self.geo_edge_iters: List[int] = []
        # injection point: ``timestamp -> depth [h, w]`` replaces the depth
        # network's output (bias = oracle, tiny uniform code basis)
        self.depth_oracle = None
        # injection point: ``timestamp -> pixel ids [N]`` replaces the seeded
        # draw of a frame's photometric samples (build_frame without loc1d=)
        self.location_source = None
        # telemetry of the last mapping_step
        self.last_step_iters = 0
        self.last_step_converged = False
        self.last_step_edges = (0, 0, 0)  # (photometric, geometric, reprojection)
        self.last_step_photo_pairs: List[tuple] = []  # its photometric edges' keyframe pairs
        self.step_iters_total = 0  # LM iterations of every mapping_step so far
        # injection point: called after the snapshot (lock released), before
        # the solve
        self.solve_hook = None

    def clone(self, device) -> "Mapper":
        """An independent copy of this mapper on ``device``: networks, store
        rows and host metadata, edge lists and budgets, and the priors'
        anchors (to hold one device's step against another's from the same
        state)."""
        copy_to = lambda t: None if t is None else t.to(dev, copy=True)  # noqa: E731
        dev = resolve_device(device)
        out = Mapper(
            self.cfg, self.cam_pyr, self.mask.cpu().numpy(),
            copy.deepcopy(self.depth_net), copy.deepcopy(self.feat_net),
            None if self.mask_in is None else self.mask_in.cpu().numpy(), device=dev,
        )
        with self.store.lock:
            src, dst = self.store, out.store
            for name, value in vars(src).items():
                if isinstance(value, torch.Tensor):
                    setattr(dst, name, copy_to(value))
                elif isinstance(value, (np.ndarray, list, dict, set, int)):
                    setattr(dst, name, copy.deepcopy(value))
            dst.variables = Variables(
                SE3(copy_to(src.variables.pose.rot), copy_to(src.variables.pose.trans)),
                copy_to(src.variables.code), copy_to(src.variables.scale),
            )
            dst.tables = None if src.tables is None else src.tables.map(lambda t, _: copy_to(t))
            out.photo_edges = list(self.photo_edges)
            out.geo_edges = list(self.geo_edges)
            out.photo_edge_iters = list(self.photo_edge_iters)
            out.geo_edge_iters = list(self.geo_edge_iters)
            out.reproj_edges = [
                {k: copy_to(v) if isinstance(v, torch.Tensor) else v for k, v in ed.items()}
                for ed in self.reproj_edges
            ]
            out.location_source = self.location_source
            for name in ("_init_scale_target", "_pose_anchor"):
                if hasattr(self, name):
                    setattr(out, name, copy.deepcopy(getattr(self, name)))
        return out

    # ------------------------------------------------------------------
    # frame construction

    def sample_locations(self, timestamp: float) -> torch.Tensor:
        """The frame's photometric pixel ids: ``location_source(timestamp)``
        where set, else a seeded permutation of the mask's valid pixels, cut
        to num_samples."""
        if self.location_source is not None:
            return self._ids(self.location_source(timestamp))
        gen = torch.Generator().manual_seed(sample_seed(timestamp))
        perm = torch.randperm(self.valid_loc1d.shape[0], generator=gen)[: self.num_samples]
        return self.valid_loc1d[perm.to(self.device)]

    def _ids(self, ids) -> torch.Tensor:
        """Injected pixel ids (a tensor or an array) as int64 on the device."""
        if isinstance(ids, torch.Tensor):
            return ids.to(self.device).long()
        return torch.as_tensor(np.array(ids), device=self.device).long()

    def _networks(self, image: torch.Tensor):
        if image.is_cuda:
            set_f32_precision()
        in_mask = (
            self.mask_in[None] if self.mask_in is not None
            else torch.ones((1, *image.shape[1:]), dtype=image.dtype, device=image.device)
        )
        with torch.no_grad():
            fmap, fdesc = feature_network.apply(self.feat_net, image, in_mask)
            bias, basis = depth_network.apply(self.depth_net, image, in_mask)
        return fmap, fdesc, bias, basis

    def _masked_mean_sq(self, bias_flat):
        return torch.sum((bias_flat * self.mask_flat) ** 2) / torch.sum(self.mask_flat)

    @timing.span("build_frame")
    def build_frame(self, timestamp: float, image, pose: Optional[SE3] = None,
                    loc1d=None) -> FrameData:
        """image [3, H, W] (input resolution). ``loc1d`` [N] injects the
        photometric pixel ids; by default they are drawn from the
        timestamp's seed. A utils/timing span ("build_frame") when timing
        is enabled."""
        dev = self.device
        image = torch.as_tensor(image, dtype=torch.float32, device=dev)
        loc1d = self.sample_locations(timestamp) if loc1d is None else self._ids(loc1d)
        fmap, fdesc, bias, basis = self._networks(image)
        cs = basis.shape[0]
        bias_flat = bias.reshape(-1)
        jac_flat = basis.reshape(cs, -1).T.contiguous()
        if self.depth_oracle is not None:
            bias_flat = torch.as_tensor(
                np.asarray(self.depth_oracle(timestamp), np.float32), device=dev
            ).reshape(-1)
            jac_flat = torch.full_like(jac_flat, 0.01)
        feat_pyr, grad_pyr = gaussian_pyramid_with_grad(fmap, self.masks_pyr, self.cam_pyr.levels)
        c = fdesc.shape[0]
        return FrameData(
            timestamp=timestamp,
            bias_flat=bias_flat,
            jac_flat=jac_flat,
            feat_pyr=feat_pyr,
            grad_pyr=grad_pyr,
            feat_desc_flat=fdesc.reshape(c, -1).T.contiguous(),
            loc1d=loc1d,
            homo=interp.locations_1d_to_homo(loc1d, self.cam_pyr[0]),
            avg_sq_bias=self._masked_mean_sq(bias_flat),  # stays on the device
            pose=pose if pose is not None else SE3.identity(device=dev),
            code=torch.zeros(self.cfg.code_size, device=dev),
            scale=1.0,
            **self.frame_tables(feat_pyr, grad_pyr, loc1d, bias_flat, jac_flat),
        )

    def frame_tables(self, feat_pyr, grad_pyr, loc1d, bias_flat, jac_flat) -> dict:
        """What build_frame derives from a frame's pyramids [C, T] and
        [2, C, T], photometric ids and depth maps, by FrameData field:
        src_feats and the frame's FrameTables (K=1). serialize.load_state
        rebuilds a restored row's with it."""
        return dict(
            src_feats=photometric.sample_source_features(feat_pyr, loc1d, self.cam_pyr),
            tables=photometric.FrameTables.build(feat_pyr, grad_pyr, self.mask_flat, self.cam_pyr,
                                                 loc1d, bias_flat, jac_flat),
        )

    # ------------------------------------------------------------------
    # keyframe lifecycle

    def init_one_frame(self, timestamp: float, image=None, loc1d=None,
                       frame: Optional[FrameData] = None) -> int:
        """Bootstrap the map from one frame: its scale normalizes the median
        depth over the mask to 1. ``frame`` passes a prebuilt frame."""
        fr = frame if frame is not None else self.build_frame(timestamp, image, loc1d=loc1d)
        depth = fr.scale * (
            fr.bias_flat[self.valid_loc1d] + fr.jac_flat[self.valid_loc1d] @ fr.code
        )
        # the median is positive for a trained depth net; an untrained one
        # is guarded so the scale stays positive
        med = max(abs(float(median(depth))), 1e-6)
        fr.scale = fr.scale / med
        kf_id = self.store.add(fr)
        self._init_scale_target = {kf_id: fr.scale}
        self._pose_anchor = kf_id
        return kf_id

    def correct_depth_scale(self, fr: FrameData, ref_id: int) -> float:
        """The new frame's scale that makes its unscaled depth agree with
        the reference keyframe: median over the valid warped points of
        z_in_new / bias_new(warp), taken on the host as np.median."""
        cam = self.cam_pyr[0]
        rel = relative_pose(fr.pose, self.store.pose(ref_id))  # new_from_ref
        d0 = self.store.depth_map(ref_id)[self.valid_loc1d]
        homo0 = interp.locations_1d_to_homo(self.valid_loc1d, cam)
        x1 = d0[:, None] * (homo0 @ rel.rot.T) + rel.trans
        pos = x1[:, 2] > self.cfg.mapper.dpt_eps
        u = x1[:, 0] / x1[:, 2] * cam.fx + cam.cx
        v = x1[:, 1] / x1[:, 2] * cam.fy + cam.cy
        bias1 = interp.bilinear_flat(fr.bias_flat[None], u, v, cam.width, cam.height)[0]
        within = interp.nearest_flat(self.mask_flat, u, v, cam.width, cam.height)
        valid = (within > 0.5) & pos & (torch.abs(bias1) > 1e-8)
        ratios = torch.where(
            valid, x1[:, 2] / torch.where(valid, bias1, torch.ones_like(bias1)),
            torch.full_like(bias1, float("nan")),
        )
        ratios_np = ratios.cpu().numpy()
        ratios_np = ratios_np[np.isfinite(ratios_np)]
        if len(ratios_np) == 0:
            return fr.scale
        return float(np.median(ratios_np))

    def enqueue_keyframe(self, fr: FrameData, back_connections: List[int]) -> int:
        """Add a keyframe and its factors to each back-connection."""
        if back_connections:
            fr.scale = self.correct_depth_scale(fr, back_connections[0])
        m = self.cfg.mapper
        with self.store.lock:
            kf_id = self.store.add(fr)
            for conn in back_connections:
                if m.use_photometric:
                    self.photo_edges += [(kf_id, conn), (conn, kf_id)]
                    self.photo_edge_iters += [m.factor_iters] * 2
                if m.use_reprojection:
                    self._add_reproj_edge(kf_id, conn)
                    self._add_reproj_edge(conn, kf_id)
                if m.use_geometric:
                    self.geo_edges += [(kf_id, conn), (conn, kf_id)]
                    self.geo_edge_iters += [m.factor_iters] * 2
                self.store.add_link(kf_id, conn)
        return kf_id

    def enqueue_frame(self, fr: FrameData, ref_id: int) -> int:
        """Add a non-keyframe refinement frame: a pose-only variable linked
        to keyframe ``ref_id`` by a one-way photometric factor (its code and
        scale stay frozen)."""
        fr.scale = self.correct_depth_scale(fr, ref_id)
        with self.store.lock:
            fid = self.store.add(fr)
            self.store.aux[fid] = True
            self.photo_edges.append((ref_id, fid))
            self.photo_edge_iters.append(self.cfg.mapper.factor_iters)
            self.store.add_link(ref_id, fid)
        return fid

    def enqueue_link(self, id0: int, id1: int, photo: bool, match_geom: bool, geo: bool,
                     global_loop: bool = False):
        """Loop-closure link; ``match_geom`` adds reprojection factors, as
        the reference's EnqueueLink does."""
        m = self.cfg.mapper
        with self.store.lock:
            if photo:
                self.photo_edges += [(id0, id1), (id1, id0)]
                self.photo_edge_iters += [m.factor_iters] * 2
            if match_geom:
                self._add_reproj_edge(id0, id1)
                self._add_reproj_edge(id1, id0)
            if geo:
                self.geo_edges += [(id0, id1), (id1, id0)]
                self.geo_edge_iters += [m.factor_iters] * 2
            self.store.add_link(id0, id1, global_loop)

    # ------------------------------------------------------------------
    # reprojection match construction

    def _reproj_edge_device(self, desc0, desc1, bias0_flat, bias1_flat, keypoints):
        """A reprojection edge's match set from keypoint ids of frame 0:
        cycle-consistent descriptor matches -> 3D points from the UNSCALED
        depth bias -> GNC-TLS translation-inlier filter. Device tensors
        only; the weight stays a device scalar."""
        cam = self.cam_pyr[0]
        m = matcher.cycle_consistent_matches(
            keypoints, desc0, desc1, cam.width,
            cyc_consis_thresh=self.cfg.mapper.desc_cyc_consis_thresh,
        )
        homo0, homo1 = matcher.matches_to_points(m, cam)
        bias1 = bias1_flat[m.loc1d_1]
        src = bias0_flat[m.loc1d_0][:, None] * homo0
        dst = bias1[:, None] * homo1
        inliers = robust.translation_inlier_filter(
            src, dst, bias1, (cam.fx + cam.fy) / 2.0, m.valid,
            noise_bound_multiplier=self.cfg.tracker.teaser_noise_bound_multiplier,
        )
        inlier_ratio = torch.sum(inliers) / self.cfg.mapper.desc_num_keypoints
        x1, y1 = interp.locations_1d_to_2d(m.loc1d_1, cam.width)
        return (
            m.loc1d_0,
            homo0,
            torch.stack([x1, y1], dim=-1),
            inliers,
            inlier_ratio * self.cfg.mapper.reproj_factor_weight,
        )

    def _add_reproj_edge(self, i0: int, i1: int, keypoints=None):
        """Build and append the edge i0 -> i1; ``keypoints`` injects the
        frame-0 keypoint ids (default: drawn from the edge's seed)."""
        if keypoints is None:
            seed = (i0 * max(self.store.num_active, 1) + i1) & 0x7FFFFFFF
            keypoints = matcher.select_keypoints(
                seed, self.valid_loc1d, self.cfg.mapper.desc_num_keypoints
            )
        keypoints = self._ids(keypoints)
        loc1d_0, homo0, matched_2d, inliers, weight = self._reproj_edge_device(
            self.store.row("feat_desc", i0), self.store.row("feat_desc", i1),
            self.store.row("bias_flat", i0), self.store.row("bias_flat", i1), keypoints,
        )
        self.reproj_edges.append(dict(
            i0=i0, i1=i1, loc1d_0=loc1d_0, homo_0=homo0, matched_2d_1=matched_2d,
            match_valid=inliers, weight=weight, iters=self.cfg.mapper.factor_iters,
        ))

    # ------------------------------------------------------------------
    # the mapping step

    def _edge_table(self, edges: List[Tuple[int, int]]) -> ba.EdgeTable:
        """Edges at their live count (see the module note)."""
        pairs = torch.as_tensor(np.asarray(edges, np.int64).reshape(-1, 2), device=self.device)
        return ba.EdgeTable(
            pairs[:, 0].contiguous(), pairs[:, 1].contiguous(),
            torch.ones(pairs.shape[0], device=self.device),
        )

    def _reproj_table(self, reproj_edges: List[dict]) -> ba.ReprojEdgeTable:
        if not reproj_edges:
            return ba.ReprojEdgeTable.empty(self.cfg.mapper.desc_num_keypoints, device=self.device)
        stack = lambda key: torch.stack([ed[key] for ed in reproj_edges])  # noqa: E731
        return ba.ReprojEdgeTable(
            i0=torch.as_tensor([ed["i0"] for ed in reproj_edges], device=self.device),
            i1=torch.as_tensor([ed["i1"] for ed in reproj_edges], device=self.device),
            valid=torch.ones(len(reproj_edges), device=self.device),
            loc1d_0=stack("loc1d_0"),
            homo_0=stack("homo_0"),
            matched_2d_1=stack("matched_2d_1"),
            match_valid=stack("match_valid"),
            weight=stack("weight"),
        )

    def _active_edge_selection(self, window_lo: int):
        """Indices of the edges incident to the window [window_lo, n).
        Frozen-frozen edges touch only masked-out rows of the damped system
        and add a constant to the accept test, so dropping them changes no
        LM decision."""
        ph = [n for n, (a, b) in enumerate(self.photo_edges) if a >= window_lo or b >= window_lo]
        ge = [n for n, (a, b) in enumerate(self.geo_edges) if a >= window_lo or b >= window_lo]
        rp = [
            n for n, ed in enumerate(self.reproj_edges)
            if ed["i0"] >= window_lo or ed["i1"] >= window_lo
        ]
        return ph, ge, rp

    def _retire_edges(self, ph_sel, ge_sel, rp_sel, iters_spent: int):
        """Count down the linearized edges' budgets and drop exhausted ones."""
        for n in ph_sel:
            self.photo_edge_iters[n] -= iters_spent
        for n in ge_sel:
            self.geo_edge_iters[n] -= iters_spent
        for n in rp_sel:
            ed = self.reproj_edges[n]
            ed["iters"] = ed.get("iters", self.cfg.mapper.factor_iters) - iters_spent
        if any(v <= 0 for v in self.photo_edge_iters):
            keep = [n for n, v in enumerate(self.photo_edge_iters) if v > 0]
            self.photo_edges = [self.photo_edges[n] for n in keep]
            self.photo_edge_iters = [self.photo_edge_iters[n] for n in keep]
        if any(v <= 0 for v in self.geo_edge_iters):
            keep = [n for n, v in enumerate(self.geo_edge_iters) if v > 0]
            self.geo_edges = [self.geo_edges[n] for n in keep]
            self.geo_edge_iters = [self.geo_edge_iters[n] for n in keep]
        if any(ed.get("iters", 1) <= 0 for ed in self.reproj_edges):
            self.reproj_edges = [ed for ed in self.reproj_edges if ed.get("iters", 1) > 0]

    def _prior_table(self, num_active: int) -> ba.PriorTable:
        """Full-capacity per-keyframe priors: the init keyframe's scale and
        pose, a code prior on every active keyframe."""
        k = self.store.capacity
        scale_valid = np.zeros(k, np.float32)
        scale_init = np.ones(k, np.float32)
        pose_valid = np.zeros(k, np.float32)
        for kf_id, s in getattr(self, "_init_scale_target", {}).items():
            scale_valid[kf_id] = 1.0
            scale_init[kf_id] = s
        if hasattr(self, "_pose_anchor"):
            pose_valid[self._pose_anchor] = 1.0
        code_valid = np.zeros(k, np.float32)
        code_valid[:num_active] = 1.0
        t = lambda a: torch.as_tensor(a, device=self.device)  # noqa: E731
        return ba.PriorTable(
            code_valid=t(code_valid), scale_valid=t(scale_valid), scale_init=t(scale_init),
            pose_valid=t(pose_valid), pose_target=SE3.identity((k,), device=self.device),
        )

    def build_problem(self, window_lo: int = 0, num_active: int | None = None,
                      selection=None) -> ba.BAProblem:
        """The full-capacity problem of the edges incident to the window
        (or of the edge ``selection`` given)."""
        n_act = num_active if num_active is not None else self.store.num_active
        ph_sel, ge_sel, rp_sel = selection or self._active_edge_selection(window_lo)
        return ba.BAProblem(
            window=self.store.window_data(self.mask_flat),
            photo_edges=self._edge_table([self.photo_edges[n] for n in ph_sel]),
            geo_edges=self._edge_table([self.geo_edges[n] for n in ge_sel]),
            priors=self._prior_table(n_act),
            reproj_edges=self._reproj_table([self.reproj_edges[n] for n in rp_sel]),
        )

    def _compact_step_inputs(self, snap_n: int, snap_vars: Variables, full: bool):
        """Under the lock: the compact problem, its variables and update
        mask, the store rows they came from and the edge selection."""
        k = self.store.capacity
        lo = 0 if full else max(0, snap_n - self.cfg.mapper.window_size)
        ph_sel, ge_sel, rp_sel = self._active_edge_selection(lo)
        idset = set(range(lo, snap_n))
        for n in ph_sel:
            idset.update(self.photo_edges[n])
        for n in ge_sel:
            idset.update(self.geo_edges[n])
        for n in rp_sel:
            idset.update((self.reproj_edges[n]["i0"], self.reproj_edges[n]["i1"]))
        ids = sorted(idset)
        kc = min(k, _round_up(max(len(ids), 2), 8))
        # pad with DISTINCT unused rows, so the write-back has unique indices
        pad_ids = [i for i in range(k) if i not in idset][: kc - len(ids)]
        ids_full = ids + pad_ids
        pad_valid = np.zeros(kc, np.float32)
        pad_valid[: len(ids)] = 1.0
        id_map = {kf: c for c, kf in enumerate(ids)}
        active = np.zeros(kc, np.float32)
        for c, kf in enumerate(ids):
            if lo <= kf < snap_n and self.store.reinitialize_count[kf] == 0:
                active[c] = 1.0
        update_mask = active
        if any(self.store.aux[kf] for kf in ids):
            comp = np.ones((kc, 7 + snap_vars.code_size), np.float32)
            for c, kf in enumerate(ids):
                if self.store.aux[kf]:
                    comp[c, 6:] = 0.0
            update_mask = active[:, None] * comp
        remap = lambda e: (id_map[e[0]], id_map[e[1]])  # noqa: E731
        problem = ba.BAProblem(
            window=self.store.window_data(self.mask_flat),
            photo_edges=self._edge_table([remap(self.photo_edges[n]) for n in ph_sel]),
            geo_edges=self._edge_table([remap(self.geo_edges[n]) for n in ge_sel]),
            priors=self._prior_table(snap_n),
            reproj_edges=self._reproj_table([
                dict(self.reproj_edges[n], i0=id_map[self.reproj_edges[n]["i0"]],
                     i1=id_map[self.reproj_edges[n]["i1"]])
                for n in rp_sel
            ]),
        )
        dev = self.device
        ids_t = torch.as_tensor(ids_full, dtype=torch.int64, device=dev)
        compact = ba.compact_problem_keyframes(
            problem, ids_t, torch.as_tensor(pad_valid, device=dev), self.cam_pyr
        )
        v_c = Variables(
            SE3(snap_vars.pose.rot[ids_t], snap_vars.pose.trans[ids_t]),
            snap_vars.code[ids_t], snap_vars.scale[ids_t],
        )
        return compact, v_c, torch.as_tensor(update_mask, device=dev), ids_t, (ph_sel, ge_sel, rp_sel)

    def _mesh_step_inputs(self, snap_n: int, snap_vars: Variables, full: bool):
        """Under the lock: the full-capacity problem of the window-incident
        edges, the update mask (sized to the active bucket, then padded to
        the capacity) and the edge selection, for the sharded step."""
        k = self.store.capacity
        lo = 0 if full else max(0, snap_n - self.cfg.mapper.window_size)
        kb = min(k, _round_up(snap_n, 8))
        active = np.zeros(kb, np.float32)
        active[lo:snap_n] = 1.0
        active[self.store.reinitialize_count[:kb] > 0] = 0.0
        update_mask = np.zeros(k, np.float32)
        update_mask[:kb] = active
        if self.store.aux[:kb].any():
            comp = np.ones((kb, 7 + snap_vars.code_size), np.float32)
            comp[self.store.aux[:kb], 6:] = 0.0
            update_mask = np.zeros((k, comp.shape[1]), np.float32)
            update_mask[:kb] = active[:, None] * comp
        selection = self._active_edge_selection(lo)
        problem = self.build_problem(num_active=snap_n, selection=selection)
        return problem, torch.as_tensor(update_mask, device=self.device), selection

    def mapping_step_sharded(self, mesh, max_iters: Optional[int] = None,
                             full: bool = False) -> float:
        """The mapping step over a process group (see mapping_step's
        ``mesh``)."""
        return self.mapping_step(max_iters=max_iters, full=full, mesh=mesh)

    def mapping_step(self, max_iters: Optional[int] = None, full: bool = False, mesh=None,
                     photo_weights: Optional[Tuple[float, ...]] = None) -> float:
        """One windowed BA solve + write-back. Returns the final graph
        error.

        ``full=True`` frees every active keyframe and linearizes every live
        edge (RefineMapping's mode, with the convergence test on); the
        default linearizes only edges incident to the sliding window.
        ``photo_weights`` overrides the per-level photometric weights of
        this solve. The problem and variables are taken under the store
        lock, the solve runs with it released, and the result is merged
        back under it (KeyframeStore.merge_variables).

        ``mesh`` (a parallel.sharded_ba.Mesh on this mapper's device) runs
        the solve edge-sharded over its process group, on the store's
        full-capacity tables: every rank must hold the same map and make
        the same call. The rows outside the active bucket are frozen and
        solve as identity blocks."""
        with timing.span("mapper.snapshot"), self.store.lock:
            if self.store.num_active < 2:
                self.last_step_iters = 0
                self.last_step_converged = False
                self.last_step_edges = (0, 0, 0)
                self.last_step_photo_pairs = []
                return 0.0
            snap_n, snap_version, snap_vars = self.store.snapshot()
            if mesh is None:
                problem, v_c, update_mask, ids, selection = self._compact_step_inputs(
                    snap_n, snap_vars, full
                )
            else:
                # the store's own tables (views): rows written during the
                # solve belong to no selected edge and are frozen
                problem, update_mask, selection = self._mesh_step_inputs(snap_n, snap_vars, full)

        if self.solve_hook is not None:
            self.solve_hook()

        with timing.span("mapper.solve"):
            mcfg = self.cfg.mapper
            if photo_weights is not None:
                mcfg = dataclasses.replace(mcfg, photo_factor_weights=tuple(photo_weights))
            if mesh is None:
                vs, err, iters, conv = ba.run_ba(
                    v_c, problem, self.cam_pyr, mcfg, update_mask,
                    max_iters or mcfg.max_gn_iters, use_conv=full,
                )
                v_full = snap_vars
                v_full.pose.rot[ids] = vs.pose.rot
                v_full.pose.trans[ids] = vs.pose.trans
                v_full.code[ids] = vs.code
                v_full.scale[ids] = vs.scale
            else:
                from ..parallel import sharded_ba

                v_full, err, iters, conv = sharded_ba.sharded_run_ba(
                    snap_vars, sharded_ba.shard_problem(problem, mesh), self.cam_pyr, mcfg,
                    update_mask, mesh, max_iters or mcfg.max_gn_iters, use_conv=full,
                )
        with timing.span("mapper.write_back"):
            err = float(err)  # the one host read of the step, outside the lock
            with self.store.lock:
                self.store.merge_variables(v_full, snap_version, snap_n)
                # a reinitialized keyframe is released after one held step
                self.store.reinitialize_count = np.maximum(self.store.reinitialize_count - 1, 0)
                # edge lists only append concurrently, so the snapshot's indices
                # stay valid; retirement runs only here
                photo_pairs = [self.photo_edges[n] for n in selection[0]]
                self._retire_edges(*selection, iters_spent=iters)
                self.step_iters_total += iters
        self.last_step_iters = iters
        self.last_step_converged = conv
        self.last_step_edges = tuple(len(s) for s in selection)
        self.last_step_photo_pairs = photo_pairs
        return err
