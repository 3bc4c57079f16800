"""Configuration surface of the framework (the port's own copy of
sage_slam_tpu/config.py; only MapperConfig.photo_reduce differs).

Mirrors the reference's ~90 gflags (system/sources/demo/main.cpp:128-313,
deepfactors_options.h:15-181) as typed dataclasses. Defaults replicate the
canonical bag_1 operating point (system/configs/slam_run.flags).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    """Camera tracker (camera_tracker.h:51-90, slam_run.flags:15-31)."""

    max_num_iters: int = 40
    min_grad_thresh: float = 1.0e-4
    min_param_inc_thresh: float = 1.0e-2
    init_damp: float = 1.0e-4
    min_damp: float = 1.0e-6
    # the reference's BUILT-IN default (main.cpp:185 tracking_min_max_damp
    # "1.0e-6,1.0e6"); its bag_1 flagfile narrows this to 1e-2
    # (slam_run.flags:21) because its trained features are nearly
    # quadratic — with generic/handcrafted features the LM needs the
    # full damping range to shrink steps instead of giving up after two
    # rejections
    max_damp: float = 1.0e6
    damp_dec_factor: float = 10.0
    damp_inc_factor: float = 100.0
    jac_update_err_inc_threshold: float = 1.0e-2
    desc_num_keypoints: int = 256
    desc_cyc_consis_thresh: float = 2.0
    reproj_factor_weight: float = 0.1
    match_geom_factor_weight: float = 0.1
    ref_kf_select_ratio: float = 0.6
    reproj_loss_param_factor: float = 0.03
    match_geom_loss_param_factor: float = 0.1
    use_reprojection: bool = True
    use_photometric: bool = True
    photo_factor_weights: Tuple[float, ...] = (10.0, 9.0, 8.0, 7.0)
    dpt_eps: float = 1.0e-6
    # robust translation-inlier filter (TEASER-equivalent) settings
    teaser_noise_bound_multiplier: float = 2.0
    # bilinear (soft) mask gate for the photometric term: the binary
    # nearest-corner gate (reference parity,
    # photometric_factor_kernels.cpp:159-166) makes the mean-normalized
    # cost discontinuous at the mask border — LM wedges on the gate-flip
    # cliffs when many samples straddle it (interp.quad_bilinear_select_cm)
    soft_inlier_gate: bool = True
    # two-phase LM: align on the two coarsest pyramid levels first,
    # then refine with all levels (tracker.lm_track). Widens the
    # convergence basin for features that are not trained-smooth; the
    # reference sums all levels at once (camera_tracker.cpp:1156)
    coarse_to_fine: bool = True


@dataclasses.dataclass(frozen=True)
class MapperConfig:
    """Mapping backend (mapper.h:35-88, slam_run.flags:88-106)."""

    use_photometric: bool = True
    use_reprojection: bool = False
    use_geometric: bool = True
    factor_iters: int = 1000
    pho_num_samples: int = 3072
    photo_factor_weights: Tuple[float, ...] = (10.0, 9.0, 8.0, 7.0)
    desc_num_keypoints: int = 512
    desc_cyc_consis_thresh: float = 2.0
    reproj_factor_weight: float = 0.1
    reproj_loss_param_factor: float = 0.03
    match_geom_factor_weight: float = 0.1
    match_geom_loss_param_factor: float = 0.1
    geo_factor_weight: float = 0.1
    geo_loss_param_factor: float = 0.03
    code_factor_weight: float = 1.0e-3
    init_pose_prior_weight: float = 1.0e4
    init_scale_prior_weight: float = 1.0e4
    update_frequency: float = 2.0
    # GN window / solver settings (TPU design; replaces ISAM2 knobs)
    window_size: int = 8
    max_gn_iters: int = 10
    gn_init_damp: float = 1.0e-4
    gn_min_damp: float = 1.0e-6
    gn_max_damp: float = 1.0e2
    gn_damp_dec_factor: float = 10.0
    gn_damp_inc_factor: float = 10.0
    dpt_eps: float = 1.0e-6
    refine_mapping_iters: int = 10
    # coarse-to-fine annealed refinement: the first N refine rounds
    # zero the FINEST half of the photometric level weights (wide
    # coarse basins first), then the full weights take over. Escapes
    # the measured local-minimum trap of the full cost (the converged
    # full-graph state sits 8% above the true geometry's cost). 0 = off.
    refine_coarse_rounds: int = 0
    # RefineMapping convergence (the ISAM2 relinearization-threshold
    # analog, deepfactors.cpp:296-313): the full-graph LM stops once an
    # accepted step's gradient or parameter increment falls below these
    relin_grad_thresh: float = 1.0e-4
    relin_param_inc_thresh: float = 1.0e-3
    # bilinear (soft) photometric mask gate (see TrackerConfig)
    soft_inlier_gate: bool = True
    # normal-equation solver inside the LM loop: "dense" (one masked
    # Cholesky of the (bd*K)^2 system), "schur" (eliminate each
    # keyframe's code+scale dims — solver/graph.schur_solve, SURVEY.md
    # §7.1; exact with the full cross-coupled Acc), or "auto" (schur
    # above schur_min_keyframes). Default dense: measured
    # (docs/SCALING_r04.md §2), the dense-Acc elimination costs MORE
    # FLOPs than one Cholesky precisely because geometric edges couple
    # codes across keyframes, and the compact windowed step already
    # bounds K to the incident set where the dense solve is trivial.
    solver: str = "dense"
    schur_min_keyframes: int = 48
    # photometric J^T W J reduce: the JAX package's two backend names are
    # kept so configs carry over; in this port both select the one reduce
    # (ops/photo_reduce.photo_reduce: the CUDA kernel for tensors on the
    # card, its plain PyTorch version for tensors on the CPU)
    photo_reduce: str = "xla"

    def __post_init__(self):
        if self.photo_reduce not in PHOTO_REDUCE_NAMES:
            raise ValueError(
                f"photo_reduce={self.photo_reduce!r}; expected one of "
                f"{PHOTO_REDUCE_NAMES}"
            )


PHOTO_REDUCE_NAMES = ("xla", "pallas")


@dataclasses.dataclass(frozen=True)
class LoopConfig:
    """Loop detection + pose-scale graph (slam_run.flags:42-73)."""

    use_global_loop: bool = True
    use_local_loop: bool = True
    max_candidates: int = 20
    local_active_window: int = 9
    global_active_window: int = 10
    tracking_max_num_iters: int = 400
    tracking_min_grad_thresh: float = 1.0e-4
    tracking_min_param_inc_thresh: float = 1.0e-2
    tracking_damp_dec_factor: float = 10.0
    tracking_damp_inc_factor: float = 30.0
    min_area_ratio: float = 0.5
    min_inlier_ratio: float = 0.5
    min_desc_inlier_ratio: float = 0.3
    local_dist_ratio: float = 5.0
    local_metric_ratio: float = 0.7
    global_sim_ratio: float = 0.7
    global_metric_ratio: float = 0.7
    detection_frequency: float = 10.0
    global_redundant_range: int = 10
    use_match_geom: bool = True
    pose_graph_local_link_weight: float = 1.0
    pose_graph_global_link_weight: float = 5.0
    pose_graph_rot_weight: float = 1.0
    pose_graph_scale_prior_weight: float = 50.0
    pose_graph_scale_weight: float = 3.0
    pose_scale_graph_max_iters: int = 200
    pose_scale_graph_no_relin_max_iters: int = 5
    pose_linearize_threshold: float = 3.0e-3
    scale_linearize_threshold: float = 1.0e-2
    # bidirectional cycle-consistency gate on 7-DoF loop verification:
    # also track ref-against-query and require the composed relative
    # pose to be near identity. A single bad loop edge at pose-graph
    # weight 5 visibly bends the whole trajectory (measured: one 17deg-
    # wrong verified edge moved keyframe Sim3-ATE from 8% to 12% of
    # span on the analytic orbit); the reference has no such gate, but
    # it also never feeds a pose-scale graph from single-pair
    # photometric verification at wide baselines without human review
    verify_cycle: bool = True
    cycle_max_rot_deg: float = 3.0
    cycle_max_trans_ratio: float = 0.5
    cycle_trans_floor: float = 0.02
    # metric translation re-fit of verified loop edges: with the
    # verified rotation fixed, (scale, t) minimizing the match-pair 3D
    # residual is a linear least-squares whose |t| carries the METRIC
    # scale of the depth maps. The photometric 7-DoF verification
    # leaves |t| weakly observable at wide baseline (r05 measured:
    # accepted edges with direction cos >= 0.99 but |t| 0.5x-3.3x of
    # GT), and the cycle gate cannot see it — both directions share
    # the bias. The edge translation is rescaled to the metric
    # magnitude; edges whose photometric |t| disagrees by more than
    # verify_metric_max_ratio (either way), whose directions disagree
    # (cos < verify_metric_min_cos) or with too few LS inliers are
    # rejected.
    # Geman-McClure robustification of LOOP edges in the pose-scale
    # graph: phi = factor * median(odometry edge residual at snapshot);
    # 0 disables (Gaussian, the reference behavior)
    pose_graph_dcs_factor: float = 3.0
    verify_metric_trans: bool = True
    verify_metric_max_ratio: float = 1.4
    # REVISIT gate: accept a global loop only when the metric baseline
    # is small relative to the scene depth (|t_ls| / median matched
    # depth). Wide-baseline cross-cavity pairs pass the BoW/overlap
    # gates inside a cavity (every view overlaps every other), but
    # their verified edges carry errors of 10-20% of baseline — larger
    # than the drift they would correct — while genuine same-viewpoint
    # revisits (the edges loop closure exists for,
    # deepfactors.cpp:81-386) verify to ~1%. 0 disables.
    global_max_baseline_ratio: float = 0.10
    verify_metric_min_cos: float = 0.95
    verify_metric_min_inliers: int = 8


@dataclasses.dataclass(frozen=True)
class KeyframeConfig:
    """New-keyframe decision (deepfactors.cpp:2020-2058, flags:34-40)."""

    max_area_ratio: float = 0.85
    max_inlier_ratio: float = 0.92
    max_desc_inlier_ratio: float = 0.4
    min_average_motion: float = 0.08
    temporal_max_back_connections: int = 3
    temporal_min_desc_inlier_ratio: float = 0.7
    pose_dist_trans_weight: float = 1.0
    pose_dist_rot_weight: float = 1.0


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    """Top-level config (DeepFactorsOptions equivalent)."""

    net_input_size: Tuple[int, int] = (128, 160)  # (H, W)
    net_output_size: Tuple[int, int] = (64, 80)
    code_size: int = 16
    feat_size: int = 16
    pyramid_levels: int = 4
    init_type: str = "ONEFRAME"
    keyframe_mode: str = "AUTO"  # AUTO | NEVER
    tracking_mode: str = "CLOSEST"  # CLOSEST | LAST | FIRST
    tracking_lost_min_error: float = 1.0e8
    tracking_lost_max_area_ratio: float = 0.2
    tracking_lost_max_inlier_ratio: float = 0.2
    max_keyframes: int = 256  # static capacity of the keyframe store

    tracker: TrackerConfig = dataclasses.field(default_factory=TrackerConfig)
    mapper: MapperConfig = dataclasses.field(default_factory=MapperConfig)
    loop: LoopConfig = dataclasses.field(default_factory=LoopConfig)
    keyframe: KeyframeConfig = dataclasses.field(default_factory=KeyframeConfig)

    @staticmethod
    def from_json(path: str) -> "SlamConfig":
        with open(path) as f:
            raw = json.load(f)
        return _from_dict(SlamConfig, raw)

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2)


def _from_dict(cls, raw: dict):
    kwargs = {}
    for field in dataclasses.fields(cls):
        if field.name not in raw:
            continue
        value = raw[field.name]
        if dataclasses.is_dataclass(field.type) if isinstance(field.type, type) else False:
            value = _from_dict(field.type, value)
        elif isinstance(value, dict):
            sub = {
                "tracker": TrackerConfig,
                "mapper": MapperConfig,
                "loop": LoopConfig,
                "keyframe": KeyframeConfig,
            }.get(field.name)
            if sub is not None:
                value = _from_dict(sub, value)
        elif isinstance(value, list):
            value = tuple(value)
        kwargs[field.name] = value
    return cls(**kwargs)
