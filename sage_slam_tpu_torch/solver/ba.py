"""Sliding-window / global bundle adjustment over the keyframe window.

Port of sage_slam_tpu/solver/ba.py. Photometric and geometric edges live in
padded edge tables, are linearized batched over the edge axis, PSD-
corrected and scatter-added into one dense block Hessian over the window;
per-keyframe priors are added; the damped GN loop (solver.graph.lm_loop)
runs the optimization.

The photometric prep and reduce of every linearization are ops/photo_prep
and ops/photo_reduce (two CUDA kernels when the problem lies on the card);
the geometric factor's is ops/geo_linearize on the card, the plain
ops/geometric chain on the CPU.
Reprojection edges (off by default, MapperConfig.use_reprojection) enter
as a third factor type.
``compact_problem_keyframes`` gathers the window-incident keyframes of a
full-capacity problem for the mapper's compact step.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import PHOTO_REDUCE_NAMES
from ..device import set_f32_precision
from ..geometry.camera import CameraPyramid
from ..geometry.se3 import SE3
from ..ops import geo_linearize, geometric, photo_prep, photometric, priors
from ..ops import reprojection as rp_ops
from ..ops.photo_reduce import photo_reduce
from ..utils import timing
from . import graph
from .graph import Variables


class WindowData(NamedTuple):
    """Per-keyframe padded arrays (leading axis K = window size)."""

    loc1d: torch.Tensor  # [K, N] sampled photometric pixel ids
    homo: torch.Tensor  # [K, N, 3]
    bias_flat: torch.Tensor  # [K, HW]
    jac_flat: torch.Tensor  # [K, HW, CS]
    feat_pyr: torch.Tensor  # [C, K, T]
    grad_pyr: torch.Tensor  # [2, C, K, T]
    src_feats: torch.Tensor  # [K, L, N, C] cached per-level source samples
    avg_sq_bias: torch.Tensor  # [K] masked mean of squared depth bias
    mask_flat: torch.Tensor  # [HW] shared video mask (full res)
    # the sampling and decode tables, kept by the keyframe store; built by
    # prepare_problem where missing
    tables: photometric.FrameTables | None = None


class EdgeTable(NamedTuple):
    """Directed factor edges kf[i0] -> frame[i1], padded with valid=0."""

    i0: torch.Tensor  # [E] int64
    i1: torch.Tensor  # [E] int64
    valid: torch.Tensor  # [E] float 0/1


class ReprojEdgeTable(NamedTuple):
    """Reprojection edges with their precomputed match sets (E edges x M
    matches)."""

    i0: torch.Tensor  # [E]
    i1: torch.Tensor  # [E]
    valid: torch.Tensor  # [E]
    loc1d_0: torch.Tensor  # [E, M]
    homo_0: torch.Tensor  # [E, M, 3]
    matched_2d_1: torch.Tensor  # [E, M, 2]
    match_valid: torch.Tensor  # [E, M]
    weight: torch.Tensor  # [E] inlier ratio * factor weight

    @staticmethod
    def empty(m: int, dtype=torch.float32, device=None) -> "ReprojEdgeTable":
        z = torch.zeros((0,), dtype=torch.int64, device=device)
        return ReprojEdgeTable(
            z, z, torch.zeros((0,), dtype=dtype, device=device),
            torch.zeros((0, m), dtype=torch.int64, device=device),
            torch.zeros((0, m, 3), dtype=dtype, device=device),
            torch.zeros((0, m, 2), dtype=dtype, device=device),
            torch.zeros((0, m), dtype=dtype, device=device),
            torch.zeros((0,), dtype=dtype, device=device),
        )


class PriorTable(NamedTuple):
    """Per-keyframe priors."""

    code_valid: torch.Tensor  # [K] code prior on every active keyframe
    scale_valid: torch.Tensor  # [K] scale prior (init keyframe / loop anchors)
    scale_init: torch.Tensor  # [K] target scale
    pose_valid: torch.Tensor  # [K] pose prior (gauge anchor)
    pose_target: SE3  # [K] target poses


class BAProblem(NamedTuple):
    window: WindowData
    photo_edges: EdgeTable
    geo_edges: EdgeTable
    priors: PriorTable
    reproj_edges: ReprojEdgeTable | None = None


def prepare_problem(problem: BAProblem, cam_pyr: CameraPyramid) -> BAProblem:
    """Build the window's tables (FrameTables.build) where it lacks them,
    and the prep kernel's pixel rows where tables converted from the JAX
    package lack them (idempotent)."""
    w = problem.window
    if w.tables is None:
        tables = photometric.FrameTables.build(w.feat_pyr, w.grad_pyr, w.mask_flat, cam_pyr,
                                               w.loc1d, w.bias_flat, w.jac_flat)
    elif w.tables.pixel_fg is None:
        pixel_fg = photo_prep.pixel_table(w.feat_pyr, w.grad_pyr, w.mask_flat, cam_pyr)
        tables = w.tables._replace(pixel_fg=pixel_fg)
    else:
        return problem
    return problem._replace(window=w._replace(tables=tables))


def slice_problem_keyframes(problem: BAProblem, kb: int, cam_pyr: CameraPyramid) -> BAProblem:
    """Restrict a full-capacity problem to its first ``kb`` keyframes
    (views, no copies, but for the packed tables). Edge tables are
    untouched: every edge index must be below kb."""
    return _select_keyframes(problem, slice(0, kb), None)


def compact_problem_keyframes(problem: BAProblem, ids: torch.Tensor,
                              pad_valid: torch.Tensor, cam_pyr: CameraPyramid) -> BAProblem:
    """Gather the window and prior rows of ``ids`` [kc] (distinct store
    rows) into a compact problem, whose tables are copies.

    The solve's dense system and per-iteration tables are then sized by
    the window-incident keyframes, not by the store. Edge tables must
    already be in compact indices; ``pad_valid`` [kc] zeroes the priors of
    padding rows, so the compact total error differs from the full one by
    a variable-independent constant."""
    return _select_keyframes(problem, ids, pad_valid)


def _select_keyframes(problem: BAProblem, sel, pad_valid) -> BAProblem:
    w = problem.window
    window = w._replace(
        loc1d=w.loc1d[sel],
        homo=w.homo[sel],
        bias_flat=w.bias_flat[sel],
        jac_flat=w.jac_flat[sel],
        feat_pyr=w.feat_pyr[:, sel],
        grad_pyr=w.grad_pyr[:, :, sel],
        src_feats=w.src_feats[sel],
        avg_sq_bias=w.avg_sq_bias[sel],
        tables=None if w.tables is None else w.tables.rows(sel),
    )
    pr = problem.priors
    gate = (lambda x: x[sel]) if pad_valid is None else (lambda x: x[sel] * pad_valid)
    priors = PriorTable(
        code_valid=gate(pr.code_valid),
        scale_valid=gate(pr.scale_valid),
        scale_init=pr.scale_init[sel],
        pose_valid=gate(pr.pose_valid),
        pose_target=SE3(pr.pose_target.rot[sel], pr.pose_target.trans[sel]),
    )
    return problem._replace(window=window, priors=priors)


def _photo_inputs(window: WindowData, e: EdgeTable):
    """Per-edge handles + SHARED flat tables (no per-edge table copies)."""
    hw = window.bias_flat.shape[-1]
    t = window.feat_pyr.shape[-1]
    c = window.feat_pyr.shape[0]
    cs = window.jac_flat.shape[-1]
    kf0 = photometric.PhotoKf0(
        window.loc1d[e.i0], window.homo[e.i0], window.src_feats[e.i0], e.i0 * hw, e.i0 * t,
        *_source_at(window, e.i0),
    )
    fr1 = photometric.PhotoFr1(base_pyr=e.i1 * t)
    shared = photometric.PhotoShared(
        bias_flat=window.bias_flat.reshape(-1),
        jac_flat=window.jac_flat.reshape(-1, cs),
        feat_pyr=window.feat_pyr.reshape(c, -1),
        grad_pyr=window.grad_pyr.reshape(2, c, -1),
        mask_flat=window.mask_flat,
        tables=window.tables,
    )
    return kf0, fr1, shared


def _source_at(window: WindowData, i0: torch.Tensor):
    """The decode tables at the source keyframes i0, or (None, None)."""
    return (None, None) if window.tables is None else window.tables.source_at(i0)


def _photo_prep(variables: Variables, window: WindowData, e: EdgeTable, cam_pyr, eps, soft):
    """K1's inputs for the photometric edges: the prep kernel on CUDA
    tensors (ops/photo_prep), the plain chain (photometric.photo_prep) on
    CPU tensors."""
    pose = variables.pose
    t = window.tables
    if photo_prep.uses_kernel(
        variables.scale, pose.rot, pose.trans, variables.code, window.homo, window.bias_flat,
        window.jac_flat, window.src_feats, window.feat_pyr, window.grad_pyr,
        *(() if t is None else (t.bias_at, t.jac_at, t.pixel_fg)),
    ):
        out = photo_prep.photo_prep_edges(
            pose.rot, pose.trans, variables.code, variables.scale, e.i0, e.i1, window, cam_pyr,
            eps, soft,
        )
        timing.count("photo.prep_kernel", 1)
        return out
    kf0, fr1, shared = _photo_inputs(window, e)
    return photometric.photo_prep(
        _edge_pose(variables, e.i0), _edge_pose(variables, e.i1), variables.code[e.i0],
        variables.scale[e.i0], kf0, fr1, shared, cam_pyr, eps, soft=soft,
    )


def _geo_inputs(window: WindowData, e: EdgeTable, variables: Variables, cam, which):
    hw = window.bias_flat.shape[-1]
    cs = window.jac_flat.shape[-1]
    kf0 = geometric.GeoKf0(window.loc1d[e.i0], window.homo[e.i0], e.i0 * hw,
                           *_source_at(window, e.i0))
    kf1 = geometric.GeoKf1(base_hw=e.i1 * hw)
    # frame-1 decode + quad pack once per keyframe per linearization;
    # edges sharing a target keyframe reuse the table
    packed_full, packed_dpt = geometric.build_frame1_tables(
        window.bias_flat, window.jac_flat, variables.code, variables.scale,
        cam, window.mask_flat, which=which,
    )
    shared = geometric.GeoShared(
        bias_flat=window.bias_flat.reshape(-1),
        jac_flat=window.jac_flat.reshape(-1, cs),
        mask_flat=window.mask_flat,
        packed_full=packed_full,
        packed_dpt=packed_dpt,
    )
    return kf0, kf1, shared


def _geo_linearize(variables: Variables, window: WindowData, e: EdgeTable, cam, cfg):
    """(ata, atb, error) of the geometric edges, not PSD-corrected: the
    kernels on CUDA tensors (ops/geo_linearize), the plain chain
    (geometric.build_frame1_tables + geometric_jac_error) on CPU tensors."""
    pose = variables.pose
    t = window.tables
    if geo_linearize.uses_kernel(
        variables.scale, pose.rot, pose.trans, variables.code, window.homo, window.bias_flat,
        window.jac_flat, window.avg_sq_bias, *(() if t is None else (t.bias_at, t.jac_at)),
    ):
        return geo_linearize.geo_linearize_edges(
            pose.rot, pose.trans, variables.code, variables.scale, e.i0, e.i1, window, cam,
            cfg.geo_loss_param_factor, cfg.geo_factor_weight, cfg.dpt_eps,
        )[:3]
    kf0, kf1, gshared = _geo_inputs(window, e, variables, cam, which="full")
    loss_param = cfg.geo_loss_param_factor * window.avg_sq_bias[e.i0]
    return geometric.geometric_jac_error(
        _edge_pose(variables, e.i0), _edge_pose(variables, e.i1),
        variables.code[e.i0], variables.code[e.i1], variables.scale[e.i0], variables.scale[e.i1],
        kf0, kf1, gshared, cam, cfg.geo_factor_weight, loss_param, cfg.dpt_eps,
    )[:3]


def _edge_pose(variables: Variables, idx: torch.Tensor) -> SE3:
    return SE3(variables.pose.rot[idx], variables.pose.trans[idx])


def _reproj_inputs(variables: Variables, problem: BAProblem, cam_pyr, cfg):
    """Per-edge arguments of the reprojection factor, or None without edges."""
    re = problem.reproj_edges
    if re is None or re.i0.shape[0] == 0:
        return None
    w = problem.window
    matches = rp_ops.ReprojMatchSet(re.loc1d_0, re.homo_0, re.matched_2d_1, re.match_valid)
    # loss_param = reproj_loss_param_factor * width^2 (mapper.cpp:357)
    loss_param = cfg.reproj_loss_param_factor * float(cam_pyr[0].width) ** 2
    return (
        _edge_pose(variables, re.i0), _edge_pose(variables, re.i1),
        variables.code[re.i0], variables.scale[re.i0],
        w.bias_flat[re.i0], w.jac_flat[re.i0], matches, cam_pyr[0], re.weight,
        loss_param, cfg.dpt_eps,
    )


def _check(variables: Variables, problem: BAProblem, cfg) -> None:
    name = getattr(cfg, "photo_reduce", "xla")
    if name not in PHOTO_REDUCE_NAMES:
        raise ValueError(f"photo_reduce={name!r}; expected one of {PHOTO_REDUCE_NAMES}")
    if variables.scale.is_cuda:
        set_f32_precision()


@timing.span("ba.linearize")
def linearize(
    variables: Variables,
    problem: BAProblem,
    cam_pyr: CameraPyramid,
    cfg,
    psd: bool = True,
):
    """Full graph linearization -> (H [D,D], b [D], error scalar)."""
    _check(variables, problem, cfg)
    k = variables.num_kf
    cs = variables.code_size
    bd = variables.block_dim
    dtype = variables.scale.dtype
    dev = variables.scale.device
    h, b = graph.empty_system(k, bd, dtype, dev)
    total_err = torch.zeros((), dtype=dtype, device=dev)
    soft = getattr(cfg, "soft_inlier_gate", False)

    sel_pose = torch.arange(6, device=dev)
    sel_code = torch.arange(6, 6 + cs, device=dev)
    sel_scale = torch.arange(6 + cs, 7 + cs, device=dev)

    # ---- photometric edges: vars (p0, p1, c0, s0), dim 13+CS ----
    with timing.span("lin.photo"):
        pe = problem.photo_edges
        if pe.i0.shape[0] > 0:
            timing.count("edges", pe.i0.shape[0])
            fgs, f0cm, gate, kx, ky = _photo_prep(
                variables, problem.window, pe, cam_pyr, cfg.dpt_eps, soft
            )
            ata, atb, err_t, n_inl = photo_reduce(
                fgs, f0cm, gate, kx, ky,
                tuple(cfg.photo_factor_weights), photometric.level_ratios(cam_pyr),
            )
            ata, atb, err, _ = photometric.photo_normalize(
                ata, atb, err_t, n_inl, cfg.photo_factor_weights
            )
            h, b, total_err = _add_block(
                h, b, total_err, bd, psd, ata, atb, err, pe.valid,
                (pe.i0, sel_pose), (pe.i1, sel_pose), (pe.i0, sel_code), (pe.i0, sel_scale),
            )

    # ---- geometric edges: vars (p0, p1, c0, c1, s0, s1), dim 14+2CS ----
    with timing.span("lin.geo"):
        ge = problem.geo_edges
        if ge.i0.shape[0] > 0:
            timing.count("edges", ge.i0.shape[0])
            ata, atb, err = _geo_linearize(variables, problem.window, ge, cam_pyr[0], cfg)
            h, b, total_err = _add_block(
                h, b, total_err, bd, psd, ata, atb, err, ge.valid,
                (ge.i0, sel_pose), (ge.i1, sel_pose), (ge.i0, sel_code), (ge.i1, sel_code),
                (ge.i0, sel_scale), (ge.i1, sel_scale),
            )

    # ---- reprojection edges: vars (p0, p1, c0, s0), dim 13+CS ----
    with timing.span("lin.reproj"):
        rp_args = _reproj_inputs(variables, problem, cam_pyr, cfg)
        if rp_args is not None:
            re = problem.reproj_edges
            timing.count("edges", re.i0.shape[0])
            ata, atb, err, _ = rp_ops.reprojection_jac_error(*rp_args)
            h, b, total_err = _add_block(
                h, b, total_err, bd, psd, ata, atb, err, re.valid,
                (re.i0, sel_pose), (re.i1, sel_pose), (re.i0, sel_code), (re.i0, sel_scale),
            )

    # ---- priors (no PSD correction) ----
    with timing.span("lin.priors"):
        pr = problem.priors
        kf_range = torch.arange(k, device=dev)
        ata, atb, err = priors.code_prior(
            variables.code, torch.zeros_like(variables.code), cfg.code_factor_weight
        )
        h, b, total_err = _add_block(h, b, total_err, bd, False, ata, atb, err, pr.code_valid,
                                     (kf_range, sel_code))
        ata, atb, err = priors.scale_prior(
            variables.scale, pr.scale_init, cfg.init_scale_prior_weight
        )
        h, b, total_err = _add_block(h, b, total_err, bd, False, ata, atb, err, pr.scale_valid,
                                     (kf_range, sel_scale))
        ata, atb, err = priors.pose_prior(
            variables.pose, pr.pose_target, cfg.init_pose_prior_weight
        )
        h, b, total_err = _add_block(h, b, total_err, bd, False, ata, atb, err, pr.pose_valid,
                                     (kf_range, sel_pose))
    return h, b, total_err


def _add_block(h, b, total_err, bd: int, psd: bool, ata, atb, err, valid, *slots):
    """One factor family into the system -> (h, b, total_err): ata
    PSD-corrected where ``psd`` is set, its blocks scattered at the slots
    (keyframe indices [E], slot selection [S]) in their order, and
    sum(err * valid) added to the error."""
    if psd:
        ata = graph.psd_correct(ata)
    idx = [graph.slot_indices(kf, bd, sel) for kf, sel in slots]
    gidx = idx[0] if len(idx) == 1 else torch.cat(idx, dim=-1)
    h, b = graph.scatter_hessian(h, b, gidx, ata, atb, valid, bd)
    return h, b, total_err + torch.sum(err * valid)


def total_error(variables: Variables, problem: BAProblem, cam_pyr, cfg):
    """Error-only evaluation for the LM accept/reject."""
    _check(variables, problem, cfg)
    total = torch.zeros((), dtype=variables.scale.dtype, device=variables.scale.device)

    pe = problem.photo_edges
    if pe.i0.shape[0] > 0:
        kf0, fr1, shared = _photo_inputs(problem.window, pe)
        err, _ = photometric.photometric_error(
            _edge_pose(variables, pe.i0), _edge_pose(variables, pe.i1),
            variables.code[pe.i0], variables.scale[pe.i0], kf0, fr1, shared,
            cam_pyr, cfg.photo_factor_weights, cfg.dpt_eps,
            soft=getattr(cfg, "soft_inlier_gate", False),
        )
        total = total + torch.sum(err * pe.valid)

    ge = problem.geo_edges
    if ge.i0.shape[0] > 0:
        kf0, kf1, gshared = _geo_inputs(
            problem.window, ge, variables, cam_pyr[0], which="dpt"
        )
        loss_param = cfg.geo_loss_param_factor * problem.window.avg_sq_bias[ge.i0]
        err, _ = geometric.geometric_error(
            _edge_pose(variables, ge.i0), _edge_pose(variables, ge.i1),
            variables.code[ge.i0], variables.code[ge.i1],
            variables.scale[ge.i0], variables.scale[ge.i1],
            kf0, kf1, gshared, cam_pyr[0], cfg.geo_factor_weight,
            loss_param, cfg.dpt_eps,
        )
        total = total + torch.sum(err * ge.valid)

    rp_args = _reproj_inputs(variables, problem, cam_pyr, cfg)
    if rp_args is not None:
        err, _ = rp_ops.reprojection_error(*rp_args)
        total = total + torch.sum(err * problem.reproj_edges.valid)

    pr = problem.priors
    _, _, err_c = priors.code_prior(
        variables.code, torch.zeros_like(variables.code), cfg.code_factor_weight
    )
    total = total + torch.sum(err_c * pr.code_valid)
    _, _, err_s = priors.scale_prior(
        variables.scale, pr.scale_init, cfg.init_scale_prior_weight
    )
    total = total + torch.sum(err_s * pr.scale_valid)
    _, _, err_p = priors.pose_prior(
        variables.pose, pr.pose_target, cfg.init_pose_prior_weight
    )
    return total + torch.sum(err_p * pr.pose_valid)


@timing.span("ba.run_ba")
def run_ba(
    variables: Variables,
    problem: BAProblem,
    cam_pyr: CameraPyramid,
    cfg,
    update_mask: torch.Tensor,
    max_iters: int | None = None,
    use_conv: bool = False,
):
    """Window BA: damped GN until convergence or budget ->
    (variables, error, iterations, converged). Runs where the tensors lie.
    With ``use_conv=True`` the loop stops once an accepted step's gradient
    or parameter increment drops below cfg.relin_grad_thresh /
    cfg.relin_param_inc_thresh."""
    _check(variables, problem, cfg)
    iters = max_iters if max_iters is not None else cfg.max_gn_iters
    with timing.span("ba.prepare"):
        problem = prepare_problem(problem, cam_pyr)
    result = graph.lm_loop(
        variables,
        lambda v: linearize(v, problem, cam_pyr, cfg),
        lambda v: total_error(v, problem, cam_pyr, cfg),
        update_mask,
        iters,
        init_damp=cfg.gn_init_damp,
        min_damp=cfg.gn_min_damp,
        max_damp=cfg.gn_max_damp,
        damp_dec=cfg.gn_damp_dec_factor,
        damp_inc=cfg.gn_damp_inc_factor,
        conv_fn=relin_conv(cfg) if use_conv else None,
        solver=resolve_solver(cfg, variables.num_kf),
    )
    timing.count("lm.iters", result[2])
    return result


def relin_conv(cfg):
    """The LM's early exit: an accepted step whose gradient or parameter
    increment drops below cfg.relin_grad_thresh / relin_param_inc_thresh."""

    def conv_fn(delta, grad):
        return torch.logical_or(
            torch.amax(torch.abs(grad)) < cfg.relin_grad_thresh,
            torch.amax(torch.abs(delta)) < cfg.relin_param_inc_thresh,
        )

    return conv_fn


def resolve_solver(cfg, num_kf: int) -> str:
    """cfg.solver, with "auto" taking "schur" at num_kf >=
    cfg.schur_min_keyframes and "dense" below."""
    solver = getattr(cfg, "solver", "dense")
    if solver == "auto":
        return "schur" if num_kf >= getattr(cfg, "schur_min_keyframes", 48) else "dense"
    return solver
