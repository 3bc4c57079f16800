"""Differentiable two-frame bundle adjustment for training (port of
sage_slam_tpu/training/diff_ba.py).

The reference's unrolled LM-BA: five cost terms assembled into one
(7+CS) damped normal-equation system per iteration, differentiated by
torch autograd through a fixed-length unroll that mirrors the JAX
package's ``lax.scan`` step for step:

* learnable scalars ``BAParams`` (field names = pretrained/ba_model.pt keys),
* the photometric term per level, weight |photo_weight*10| *
  (2^l)^photo_pow_factor, through ops/photometric (K1 on the card: its
  forward is the CUDA kernel, its backward the closed form of
  ops/photo_reduce.photo_reduce_backward),
* the match-geometry term (Fair-robust 3D point pairs against FIXED matched
  target depths), the reprojection term (Cauchy-robust 2D), the geometry
  term at the finest level against the FIXED target depth map (frame 1
  decoded per edge, no prebuilt tables), the code prior and the log-scale
  prior,
* the LM loop: ``max_iters`` steps, each a damped solve and a fixed
  3-attempt damping search (accept iff the candidate error falls and the
  damped system's condition number is below max_cond), with the accept,
  converged and give-up flags kept as tensors and applied with
  ``torch.where``: no host read and no Python branch on a device value
  inside the loop.

Variables (solution order as the reference): pose tangent (6), scale (1),
the SOURCE frame's code (CS). The target frame's depth and features are
fixed. Every function works on one pair; the photometric and geometric
factors run batched at E=1.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import resolve_device
from ..geometry import se3 as se3m
from ..geometry.camera import CameraPyramid
from ..geometry.se3 import SE3, se3_exp
from ..ops import geometric, photometric

# BAParams.init, in field order (the reference configs/training.json:84-92)
_BA_DEFAULTS = (0.0, 0.8, 0.1, 0.1, 0.1, 0.05, 1.0e-3, 1.0e-4, 0.1, 0.03)


class BAParams(NamedTuple):
    """Learnable BA scalars (0-d tensors); field names = the reference's
    pretrained/ba_model.pt keys. The last four are constructor constants
    in the reference (not trained there)."""

    photo_pow_factor: torch.Tensor
    photo_weight: torch.Tensor
    match_geom_param_factor: torch.Tensor
    match_geom_term_weight: torch.Tensor
    geometry_cauchy_param_factor: torch.Tensor
    geometry_term_weight: torch.Tensor
    code_term_weight: torch.Tensor
    scale_term_weight: torch.Tensor
    reproj_term_weight: torch.Tensor
    reproj_cauchy_param: torch.Tensor

    @staticmethod
    def init(levels: int = 4, device=None) -> "BAParams":
        del levels  # per-level weights derive from the learnable power
        dev = resolve_device(device)
        return BAParams(*(torch.tensor(v, dtype=torch.float32, device=dev)
                          for v in _BA_DEFAULTS))


def load_ba_model(path: str, device=None) -> BAParams:
    """The reference's trained BA scalars (pretrained/ba_model.pt); absent
    keys keep BAParams.init's values."""
    import numpy as np

    dev = resolve_device(device)
    sd = torch.load(path, map_location="cpu", weights_only=False)["model"]
    base = BAParams.init(device=dev)
    return BAParams(*(
        torch.tensor(float(np.asarray(sd[name]).reshape(())), dtype=torch.float32, device=dev)
        if name in sd else getattr(base, name)
        for name in BAParams._fields
    ))


class BAState(NamedTuple):
    tau10: torch.Tensor  # [6] relative pose tangent (frame1-from-frame0)
    scale0: torch.Tensor  # []
    code0: torch.Tensor  # [CS]


class MatchSet(NamedTuple):
    """Keypoint matches for the match-geometry / reprojection terms."""

    homo0: torch.Tensor  # [M, 3] keypoint rays in frame 0
    bias0: torch.Tensor  # [M] depth bias at the keypoints
    jac0: torch.Tensor  # [M, CS] depth jacobian rows at the keypoints
    match_homo1: torch.Tensor  # [M, 3] matched rays in frame 1
    match_depths: torch.Tensor  # [M] FIXED matched target depths
    matched_2d: torch.Tensor  # [M, 2] matched (x, y) pixels in frame 1
    valid: torch.Tensor  # [M] 0/1


def _hat_rows(x1: torch.Tensor) -> torch.Tensor:
    """[M, 3] -> [M, 3, 3]: the match term's pose block rows
    (diff_ba.py's sign convention)."""
    z = torch.zeros_like(x1[:, 0])
    return torch.stack([
        torch.stack([z, x1[:, 2], -x1[:, 1]], dim=-1),
        torch.stack([-x1[:, 2], z, x1[:, 0]], dim=-1),
        torch.stack([-x1[:, 1], -x1[:, 0], z], dim=-1),
    ], dim=1)


def _match_geometry_term(params: BAParams, state: BAState, ms: MatchSet, mean_sq_depth, t10: SE3):
    """Fair-robust 3D point-pair term -> (ata, atb, err) over [pose, scale,
    code]."""
    m = ms.homo0.shape[0]
    cs = state.code0.shape[0]
    depths0 = state.scale0 * (ms.bias0 + ms.jac0 @ state.code0)  # [M]
    rh = ms.homo0 @ t10.rot.T
    x1 = depths0[:, None] * rh + t10.trans
    match_3d = ms.match_depths[:, None] * ms.match_homo1
    diff = (match_3d - x1) * ms.valid[:, None]

    slp = torch.sqrt(torch.abs(params.match_geom_param_factor * mean_sq_depth))
    norm = torch.abs(diff) / slp
    fair_err = torch.sum(2.0 * (norm - torch.log1p(norm)), dim=-1)  # [M]
    sw = (1.0 / slp) * torch.sqrt(1.0 / (1.0 + norm))  # [M, 3]

    eye = torch.eye(3, dtype=x1.dtype, device=x1.device).expand(m, 3, 3)
    jac_pose = torch.cat([_hat_rows(x1), eye], dim=2)  # [M, 3, 6]
    jac_scale = (rh * (depths0 / state.scale0)[:, None])[..., None]
    jac_code = rh[..., None] * (state.scale0 * ms.jac0[:, None, :])  # [M, 3, CS]
    jac = torch.cat([jac_pose, jac_scale, jac_code], dim=2)
    jac = (sw * ms.valid[:, None])[..., None] * jac  # [M, 3, 7+CS]
    res = (sw * diff).reshape(m * 3)
    a = jac.reshape(m * 3, 7 + cs)
    w = torch.abs(params.match_geom_term_weight)
    ata = w * a.T @ a / m
    atb = w * a.T @ res / m
    err = w * torch.sum(fair_err * ms.valid) / torch.clamp(torch.sum(ms.valid), min=1.0)
    return ata, atb, err


def _reproj_term(params: BAParams, state: BAState, ms: MatchSet, cam, t10: SE3, dpt_eps: float):
    """Cauchy-robust 2D reprojection term -> (ata, atb, err)."""
    m = ms.homo0.shape[0]
    cs = state.code0.shape[0]
    depths0 = state.scale0 * (ms.bias0 + ms.jac0 @ state.code0)
    rh = ms.homo0 @ t10.rot.T
    x1 = depths0[:, None] * rh + t10.trans
    z = x1[:, 2]
    pos = (z >= dpt_eps).to(x1.dtype) * ms.valid
    z = torch.clamp(z, min=dpt_eps)
    u = x1[:, 0] / z * cam.fx + cam.cx
    v = x1[:, 1] / z * cam.fy + cam.cy
    diff = (ms.matched_2d - torch.stack([u, v], dim=-1)) * pos[:, None]

    cauchy_param = torch.abs(params.reproj_cauchy_param) * float(cam.width) ** 2
    w = torch.abs(params.reproj_term_weight)
    sq = diff.reshape(-1) ** 2
    sqrt_w = torch.sqrt(w / (sq + cauchy_param))
    npos = torch.clamp(torch.sum(pos), min=1.0)
    err = torch.sum(w * torch.log1p(sq / cauchy_param)) / npos

    # d(u, v)/d(x1), then d(x1)/d(pose tangent [trans, rot]) = [I | -hat(x1)]
    zero = torch.zeros_like(z)
    jp = torch.stack([
        torch.stack([cam.fx / z, zero, -cam.fx * x1[:, 0] / z**2], dim=-1),
        torch.stack([zero, cam.fy / z, -cam.fy * x1[:, 1] / z**2], dim=-1),
    ], dim=1)  # [M, 2, 3]
    eye = torch.eye(3, dtype=x1.dtype, device=x1.device).expand(m, 3, 3)
    dx_dpose = torch.cat([eye, -se3m.hat(x1)], dim=2)  # [M, 3, 6]
    jac_pose = jp @ dx_dpose
    jac_scale = jp @ (rh * (depths0 / state.scale0)[:, None])[..., None]
    jac_code = jp @ (rh[..., None] * (state.scale0 * ms.jac0[:, None, :]))
    jac = torch.cat([jac_pose, jac_scale, jac_code], dim=2)
    # the residual is (matched - projected): d(res)/d(vars) = -jac
    jac = -(pos[:, None, None] * jac)
    a = sqrt_w[:, None] * jac.reshape(m * 2, 7 + cs)
    res = sqrt_w * diff.reshape(-1)
    return a.T @ a / npos, a.T @ res / npos, err


class BAInputs(NamedTuple):
    """Everything the linearization needs (fixed tensors; the per-edge
    handles carry a leading E=1 axis)."""

    kf0: photometric.PhotoKf0
    fr1: photometric.PhotoFr1
    photo_shared: photometric.PhotoShared
    geo_kf0: geometric.GeoKf0
    geo_kf1: geometric.GeoKf1
    geo_shared: geometric.GeoShared
    matches: MatchSet | None
    mean_sq_depth: torch.Tensor  # [] masked mean of the squared target depth
    init_scale: torch.Tensor  # [] scale-prior target


def photo_level_weights(params: BAParams, levels: int) -> torch.Tensor:
    """[L]: |photo_weight*10| * (2^l)^photo_pow_factor (finest level first)."""
    return torch.stack([
        torch.abs(params.photo_weight * 10.0) * (2.0**lvl) ** params.photo_pow_factor
        for lvl in range(levels)
    ])


def _linearize(params: BAParams, state: BAState, inp: BAInputs, cam_pyr: CameraPyramid,
               dpt_eps: float, use_match_geom: bool, use_geom: bool, use_reproj: bool,
               weights: torch.Tensor, host_weights):
    """-> (ata [7+CS, 7+CS], atb [7+CS], err []). ``weights`` are
    photo_level_weights(params), ``host_weights`` their floats."""
    cs = state.code0.shape[0]
    dim = 7 + cs
    dev, dt = state.code0.device, state.code0.dtype
    t10 = se3_exp(state.tau10)
    p0 = SE3(t10.rot[None], t10.trans[None])
    p1 = SE3.identity((1,), dtype=dt, device=dev)

    # solution order [pose(6), scale(1), code(CS)]
    idx_code = torch.arange(7, dim, device=dev)
    dst = torch.arange(dim, device=dev)

    a_p, b_p, err_p, _ = photometric.photometric_jac_error(
        p0, p1, state.code0[None], state.scale0[None], inp.kf0, inp.fr1,
        inp.photo_shared, cam_pyr, weights, dpt_eps, host_weights=host_weights,
    )
    # photometric block layout [p0(6), p1(6), c0(CS), s0(1)]
    sub = torch.cat([torch.arange(6, device=dev), torch.tensor([12 + cs], device=dev),
                     torch.arange(12, 12 + cs, device=dev)])
    ata = torch.zeros((dim, dim), dtype=dt, device=dev).index_put(
        (dst[:, None], dst[None, :]), a_p[0][sub][:, sub], accumulate=True)
    atb = torch.zeros((dim,), dtype=dt, device=dev).index_put((dst,), b_p[0][sub], accumulate=True)
    err = err_p[0]

    if use_match_geom and inp.matches is not None:
        a_m, b_m, e_m = _match_geometry_term(params, state, inp.matches, inp.mean_sq_depth, t10)
        ata, atb, err = ata + a_m, atb + b_m, err + e_m

    if use_reproj and inp.matches is not None:
        a_r, b_r, e_r = _reproj_term(params, state, inp.matches, cam_pyr[0], t10, dpt_eps)
        ata, atb, err = ata + a_r, atb + b_r, err + e_r

    # zero-code prior: A = [0 | I], AtA normalized by CS
    code_w = torch.abs(params.code_term_weight) / cs
    ata = ata.index_put((idx_code, idx_code), code_w.expand(cs), accumulate=True)
    atb = atb.index_put((idx_code,), -code_w * state.code0, accumulate=True)
    err = err + torch.abs(params.code_term_weight) * torch.mean(state.code0**2)

    if use_geom:
        # geometry at the finest level against the FIXED target depth: the
        # factor's (c1, s1) blocks are not scattered
        a_g, b_g, e_g, _ = geometric.geometric_jac_error(
            p0, p1, state.code0[None], torch.zeros((1, cs), dtype=dt, device=dev),
            state.scale0[None], torch.ones((1,), dtype=dt, device=dev),
            inp.geo_kf0, inp.geo_kf1, inp.geo_shared, cam_pyr[0],
            torch.abs(params.geometry_term_weight),
            (torch.abs(params.geometry_cauchy_param_factor) * inp.mean_sq_depth)[None],
            dpt_eps,
        )
        # geometric block layout [p0, p1, c0, c1, s0, s1]
        sub_g = torch.cat([torch.arange(6, device=dev), torch.tensor([12 + 2 * cs], device=dev),
                           torch.arange(12, 12 + cs, device=dev)])
        ata = ata.index_put((dst[:, None], dst[None, :]), a_g[0][sub_g][:, sub_g], accumulate=True)
        atb = atb.index_put((dst,), b_g[0][sub_g], accumulate=True)
        err = err + e_g[0]

    # log-scale prior
    scale_w = torch.abs(params.scale_term_weight)
    s = torch.clamp(state.scale0, min=1e-8)
    log_diff = torch.log(inp.init_scale) - torch.log(s)
    six = torch.tensor([6], device=dev)
    ata = ata.index_put((six, six), (scale_w / (s * s))[None], accumulate=True)
    atb = atb.index_put((six,), (scale_w / s * log_diff)[None], accumulate=True)
    err = err + scale_w * log_diff**2
    return ata, atb, err


SCALE_MIN = 1e-3  # _update's floor on the scale


def _update(state: BAState, sol: torch.Tensor) -> BAState:
    """Left-multiplicative pose, additive scale and code; solution order
    [pose, scale, code]."""
    new_t10 = se3m.compose(se3_exp(sol[:6]), se3_exp(state.tau10))
    return BAState(
        tau10=se3m.se3_log(new_t10),
        scale0=torch.clamp(state.scale0 + sol[6], min=SCALE_MIN),
        code0=state.code0 + sol[7:],
    )


class _BwdClip(torch.autograd.Function):
    """Identity forward; the cotangent's norm is clipped to max_norm on the
    backward pass (max_norm <= 0: unclipped). With ba_optimize.record set
    when the forward ran, the backward records the pre-clip norm."""

    @staticmethod
    def forward(ctx, x, max_norm: float):
        ctx.max_norm = float(max_norm)
        ctx.record = ba_optimize.record
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        if ctx.max_norm <= 0:
            return g, None
        norm = torch.sqrt(torch.sum(g * g))
        if ctx.record is not None:
            ctx.record.append(("clip_norm", norm.detach()))
            ctx.record.append(("clipped", (norm > ctx.max_norm).detach()))
        factor = torch.clamp(ctx.max_norm / torch.clamp(norm, min=1e-12), max=1.0)
        return g * factor, None


def _bwd_clip(x: torch.Tensor, max_norm: float) -> torch.Tensor:
    """Between unrolled LM iterations it bounds the geometric growth of
    the gradients through the unroll (truncated-BPTT style clipping)."""
    return _BwdClip.apply(x, max_norm)


def _clip_state_grad(state: BAState, max_norm: float) -> BAState:
    """Jointly clip the backward cotangent of the whole BA state."""
    flat = _bwd_clip(torch.cat([state.tau10, state.scale0.reshape(1), state.code0]), max_norm)
    return BAState(tau10=flat[:6], scale0=flat[6], code0=flat[7:])


def _select(flag: torch.Tensor, a: BAState, b: BAState) -> BAState:
    return BAState(*(torch.where(flag, x, y) for x, y in zip(a, b)))


def ba_optimize(
    params: BAParams,
    inp: BAInputs,
    cam_pyr: CameraPyramid,
    init: BAState,
    max_iters: int = 8,
    inner_attempts: int = 3,
    init_damp: float = 1.0e-4,
    damp_min: float = 1.0e-8,
    damp_max: float = 1.0e8,
    damp_inc: float = 10.0,
    damp_dec: float = 10.0,
    grad_thresh: float = 1.0e-4,
    param_thresh: float = 1.0e-2,
    max_cond: float = 1.0e9,
    dpt_eps: float = 1.0e-3,
    use_match_geom: bool = True,
    use_geom: bool = True,
    use_reproj: bool = False,
    bwd_clip: float = 0.0,
):
    """The reference LM schedule as a fixed unroll of ``max_iters`` steps
    -> (final BAState, per-iteration errors [max_iters]).

    Each step linearizes, solves the damped system, runs the fixed inner
    damping search, applies the accepted update unless already done, and
    sets the done flag from the gradient / relative-increment thresholds or
    a give-up at damp_max. The condition numbers enter comparisons only,
    detached.

    Every branch the unroll's gradient can take is recorded when
    ``ba_optimize.record`` is a list (None, the default, records nothing):
    in order, (kind, detached device tensor) pairs, "zeroed" per solve (a
    non-finite solution replaced by zeros), per damping attempt "clamp"
    (the candidate's scale clamp binds), "select" (the attempt's accept
    flag), "taken" (its solution reaches the returned state) and "cond"
    (its damped system's condition number), per iteration "select" (the
    state update's flag), and per cotangent through _BwdClip on the
    backward pass "clip_norm" (its norm before the clip) and "clipped".
    ``branch_record`` reads them."""
    rec = ba_optimize.record
    dev, dt = init.code0.device, init.code0.dtype
    dim = 7 + init.code0.shape[0]
    eye = torch.eye(dim, dtype=dt, device=dev)
    weights = photo_level_weights(params, cam_pyr.levels)
    host_weights = weights.detach().cpu().tolist()  # the kernel's floats, read once

    def linearize(state):
        return _linearize(params, state, inp, cam_pyr, dpt_eps, use_match_geom, use_geom,
                          use_reproj, weights, host_weights)

    def solve(ata, atb, damp):
        damped = ata + damp * torch.diag(torch.diagonal(ata)) + 1e-10 * eye
        sol = torch.linalg.solve_ex(damped, atb)[0]  # a singular system gives non-finite values
        cond = torch.linalg.cond(damped.detach())
        finite = torch.isfinite(sol)
        if rec is not None:
            rec.append(("zeroed", ~finite.all()))
        return torch.where(finite, sol, torch.zeros_like(sol)), cond

    state = init
    damp = torch.tensor(init_damp, dtype=dt, device=dev)
    done = torch.tensor(False, device=dev)
    errs = []
    for _ in range(max_iters):
        if bwd_clip > 0:
            state = _clip_state_grad(state, bwd_clip)
        ata, atb, err0 = linearize(state)
        sol, cond = solve(ata, atb, damp)

        # convergence (lm_convergence)
        max_grad = torch.max(torch.abs(atb))
        denom = torch.cat([
            torch.abs(state.tau10[3:6]) + 1e-8,
            torch.abs(state.tau10[:3]) + 1e-8,
            state.scale0.reshape(1),
            torch.abs(state.code0) + 1e-8,
        ])
        sol_perm = torch.cat([sol[3:6], sol[:3], sol[6:7], sol[7:]])
        rel_inc = torch.max(torch.abs(sol_perm / denom))
        converged = (max_grad <= grad_thresh) | (rel_inc <= param_thresh)

        # inner damping search, fixed unroll
        best_state = state
        accepted = torch.tensor(False, device=dev)
        cur_damp, cur_sol, cur_cond = damp, sol, cond
        for _ in range(inner_attempts):
            cand = _update(state, cur_sol)
            cand_err = linearize(cand)[2]
            ok = (cand_err < err0) & (cur_cond < max_cond) & ~accepted
            if rec is not None:
                rec += [("clamp", (state.scale0 + cur_sol[6]).detach() < SCALE_MIN),
                        ("select", ok), ("taken", ok & ~done), ("cond", cur_cond)]
            best_state = _select(ok, cand, best_state)
            accepted = accepted | ok
            next_damp = torch.clamp(cur_damp * damp_inc, damp_min, damp_max)
            nsol, ncond = solve(ata, atb, next_damp)
            cur_damp = torch.where(accepted, cur_damp, next_damp)
            cur_sol = torch.where(accepted, cur_sol, nsol)
            cur_cond = torch.where(accepted, cur_cond, ncond)

        new_damp = torch.where(accepted, torch.clamp(cur_damp / damp_dec, damp_min, damp_max),
                               cur_damp)
        give_up = ~accepted & (cur_damp >= damp_max)
        active = ~done
        if rec is not None:
            rec.append(("select", active & accepted))
        state = _select(active & accepted, best_state, state)
        damp = torch.where(active, new_damp, damp)
        done = done | converged | give_up
        errs.append(err0)
    return state, torch.stack(errs)


ba_optimize.record = None


def branch_record(record) -> dict:
    """ba_optimize.record on the host -> {kind: [bool or float, ...]} in
    recorded order."""
    out = {}
    for kind, value in record:
        out.setdefault(kind, []).append(value.item())
    return out


def ba_outputs(state: BAState, bias0_flat, jac0_flat, cam, dpt_eps=1e-6):
    """Supervision outputs: frame 0's final depth map [H, W] and the dense
    rigid flow 0 -> 1 [2, H, W] implied by the BA estimate."""
    from ..geometry import interp
    from ..ops.depth import decode_depth

    depth0 = decode_depth(bias0_flat, jac0_flat, state.code0, state.scale0)
    hw = bias0_flat.shape[0]
    loc = torch.arange(hw, device=bias0_flat.device)
    homo = interp.locations_1d_to_homo(loc, cam)
    t10 = se3_exp(state.tau10)
    x1 = depth0[:, None] * (homo @ t10.rot.T) + t10.trans
    z = torch.clamp(x1[:, 2], min=dpt_eps)
    u = x1[:, 0] / z * cam.fx + cam.cx
    v = x1[:, 1] / z * cam.fy + cam.cy
    x0, y0 = interp.locations_1d_to_2d(loc, cam.width)
    flow = torch.stack([u - x0, v - y0], dim=0).reshape(2, cam.height, cam.width)
    return depth0.reshape(cam.height, cam.width), flow
