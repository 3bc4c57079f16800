"""Loop-closure pose + scale graph (port of sage_slam_tpu/loop/pose_graph.py).

Every keyframe's (pose, scale) is a variable block of dim 7 = [pose(6),
scale(1)] (Variables with an empty code block). Edges are a table of
RelPoseScaleFactor edges, linearized together (ops/priors.
rel_pose_scale_factor, batched over edges), scatter-added into the dense
block Hessian with the pose and scale priors and solved by the shared LM
loop (solver/graph.lm_loop).

Graph content (built by SlamSystem.close_global_loops): a strong pose
prior and a scale prior on the first keyframe, both directions of every
temporal link (local weight), of every earlier global loop and of every
new loop (global weight times the verification quality), and scale priors
on the first new loop's pair. Loop edges (``is_loop``) get a Geman-McClure
robust kernel when ``dcs_phi`` > 0.

``propagate_newer_keyframes`` moves keyframes created after the graph's
snapshot rigidly with the last in-graph keyframe, their translation scaled
by its scale change.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch

from ..geometry import se3 as se3m
from ..geometry.se3 import SE3
from ..ops import priors as prior_ops
from ..solver import graph
from ..solver.graph import Variables


class PoseScaleEdges(NamedTuple):
    """Directed RelPoseScaleFactor edges [E]."""

    i0: torch.Tensor  # [E]
    i1: torch.Tensor  # [E]
    target_rot: torch.Tensor  # [E, 3, 3] target T10 = T1^-1 T0
    target_trans: torch.Tensor  # [E, 3]
    target_scale0: torch.Tensor  # [E]
    target_scale1: torch.Tensor  # [E]
    weight: torch.Tensor  # [E] link weight
    valid: torch.Tensor  # [E]
    # 1 for loop edges (new and earlier global loops), 0 for odometry links
    is_loop: Optional[torch.Tensor] = None


class PoseScalePriors(NamedTuple):
    pose_valid: torch.Tensor  # [K]
    pose_target: SE3  # [K]
    pose_weight: float
    scale_valid: torch.Tensor  # [K]
    scale_target: torch.Tensor  # [K]
    scale_weight: torch.Tensor  # [K] per-keyframe prior weight


def _edge_linearize(variables: Variables, e: PoseScaleEdges, cfg, dcs_phi: float = 0.0):
    """Every edge's (AtA [E, 14, 14], Atb [E, 14], error [E]); with dcs_phi
    > 0 the loop edges are reweighted by Geman-McClure IRLS: cost
    phi r2 / (phi + r2), weight (phi / (phi + r2))^2."""
    v = variables
    ata, atb, err = prior_ops.rel_pose_scale_factor(
        SE3(v.pose.rot[e.i0], v.pose.trans[e.i0]), SE3(v.pose.rot[e.i1], v.pose.trans[e.i1]),
        v.scale[e.i0], v.scale[e.i1], SE3(e.target_rot, e.target_trans), e.target_scale0,
        e.target_scale1, e.weight, cfg.pose_graph_rot_weight, cfg.pose_graph_scale_weight,
    )
    if dcs_phi > 0 and e.is_loop is not None:
        loop = e.is_loop > 0
        s = torch.where(loop, (dcs_phi / (dcs_phi + err)) ** 2, torch.ones_like(err))
        err = torch.where(loop, dcs_phi * err / (dcs_phi + err), err)
        ata = ata * s[:, None, None]
        atb = atb * s[:, None]
    return ata, atb, err


def _prior_errors(variables: Variables, pr: PoseScalePriors):
    ata_p, atb_p, err_p = prior_ops.pose_prior(variables.pose, pr.pose_target, pr.pose_weight)
    ata_s, atb_s, err_s = prior_ops.scale_prior(variables.scale, pr.scale_target, pr.scale_weight)
    return (ata_p, atb_p, err_p), (ata_s, atb_s, err_s)


def linearize(variables: Variables, edges: PoseScaleEdges, pr: PoseScalePriors, cfg,
              dcs_phi: float = 0.0):
    """-> (H [7K, 7K], b [7K], total error)."""
    k, bd = variables.num_kf, variables.block_dim  # 7 (code size 0)
    dtype, dev = variables.scale.dtype, variables.scale.device
    h, b = graph.empty_system(k, bd, dtype, dev)
    total = torch.zeros((), dtype=dtype, device=dev)
    sel_pose = torch.arange(6, device=dev)
    sel_scale = torch.arange(6, 7, device=dev)

    ata, atb, err = _edge_linearize(variables, edges, cfg, dcs_phi)
    ata = graph.psd_correct(ata)
    # block layout of rel_pose_scale_factor: [p0, p1, s0, s1]
    gidx = torch.cat([
        graph.slot_indices(edges.i0, bd, sel_pose), graph.slot_indices(edges.i1, bd, sel_pose),
        graph.slot_indices(edges.i0, bd, sel_scale), graph.slot_indices(edges.i1, bd, sel_scale),
    ], dim=-1)  # [E, 14]
    h, b = graph.scatter_hessian(h, b, gidx, ata, atb, edges.valid, bd)
    total = total + torch.sum(err * edges.valid)

    kf_range = torch.arange(k, device=dev)
    (ata_p, atb_p, err_p), (ata_s, atb_s, err_s) = _prior_errors(variables, pr)
    h, b = graph.scatter_hessian(h, b, graph.slot_indices(kf_range, bd, sel_pose), ata_p, atb_p,
                                 pr.pose_valid, bd)
    total = total + torch.sum(err_p * pr.pose_valid)
    h, b = graph.scatter_hessian(h, b, graph.slot_indices(kf_range, bd, sel_scale), ata_s, atb_s,
                                 pr.scale_valid, bd)
    total = total + torch.sum(err_s * pr.scale_valid)
    return h, b, total


def error_only(variables: Variables, edges: PoseScaleEdges, pr: PoseScalePriors, cfg,
               dcs_phi: float = 0.0):
    _, _, err = _edge_linearize(variables, edges, cfg, dcs_phi)
    total = torch.sum(err * edges.valid)
    (_, _, err_p), (_, _, err_s) = _prior_errors(variables, pr)
    total = total + torch.sum(err_p * pr.pose_valid)
    return total + torch.sum(err_s * pr.scale_valid)


def optimize(variables: Variables, edges: PoseScaleEdges, pr: PoseScalePriors, cfg,
             active_mask: torch.Tensor, max_iters: Optional[int] = None, dcs_phi: float = 0.0):
    """Damped GN over the pose-scale graph -> (variables, error, iterations).

    The budget is cfg.pose_scale_graph_max_iters; the loop stops once an
    accepted step's pose / scale deltas fall below
    cfg.pose_linearize_threshold / cfg.scale_linearize_threshold (the
    reference iterates ISAM2 update() only while variables relinearize)."""
    iters = max_iters if max_iters is not None else cfg.pose_scale_graph_max_iters

    def converged(delta, grad):
        # delta [K, 7] = [pose(6), scale(1)], frozen rows already zeroed
        pose_ok = torch.max(torch.abs(delta[:, :6])) < cfg.pose_linearize_threshold
        return pose_ok & (torch.max(torch.abs(delta[:, 6])) < cfg.scale_linearize_threshold)

    v, err, it, _ = graph.lm_loop(
        variables,
        lambda v_: linearize(v_, edges, pr, cfg, dcs_phi),
        lambda v_: error_only(v_, edges, pr, cfg, dcs_phi),
        active_mask, iters, init_damp=1e-4, min_damp=1e-8, max_damp=1e4, damp_dec=10.0,
        damp_inc=10.0, conv_fn=converged,
    )
    return v, err, it


def make_pose_scale_variables(pose: SE3, scale: torch.Tensor) -> Variables:
    """Variables with an empty code block (block dim 7)."""
    return Variables(pose, torch.zeros((scale.shape[0], 0), dtype=scale.dtype, device=scale.device), scale)


def propagate_newer_keyframes(pose_all: SE3, scale_all: torch.Tensor, new_pose: SE3,
                              new_scale: torch.Tensor, last_in_graph: int, newer_ids: List[int]):
    """Rigid + scaled propagation to keyframes created after the graph:
    pose_all / scale_all [K] are the pre-update values (the newer
    keyframes' current ones), new_pose / new_scale [K] the solved ones
    (valid for in-graph rows) -> {id: (SE3, scale)}. Every value is computed
    before this returns, so rows of pose_all may be overwritten after."""
    prev_last = SE3(pose_all.rot[last_in_graph], pose_all.trans[last_in_graph])
    upd_last = SE3(new_pose.rot[last_in_graph], new_pose.trans[last_in_graph])
    ratio = new_scale[last_in_graph] / scale_all[last_in_graph]
    ids = torch.as_tensor(newer_ids, dtype=torch.int64, device=scale_all.device)
    rel = se3m.compose(se3m.inverse(prev_last), SE3(pose_all.rot[ids], pose_all.trans[ids]))
    moved = se3m.compose(upd_last, SE3(rel.rot, rel.trans * ratio))
    scales = scale_all[ids] * ratio
    return {i: (SE3(moved.rot[n], moved.trans[n]), scales[n]) for n, i in enumerate(newer_ids)}
