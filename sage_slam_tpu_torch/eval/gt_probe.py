"""BA-from-exact-GT walk-away probe, the estimator-floor diagnostic (port
of sage_slam_tpu/eval/gt_probe.py).

Full-graph BA started at EXACT ground-truth poses with ORACLE depth walks
away from the ground truth when the photometric cost's minimum is biased.
This probe measures that walk and decomposes it:

1. ``grad``   — per-term gradient (Atb) at exact GT, split by factor type
               and by variable class (rot / trans / code / scale);
2. ``walk``   — the full refine loop from GT: the final Sim3-aligned
               keyframe ATE plus per-keyframe scale/code drift;
3. ``section``— 1D cost sections through GT along a chosen keyframe's
               translation/rotation axes for each term separately: where
               each term's own minimum sits (in % of the sweep span).

The scene is the analytic Bowl3D orbit, depth is the oracle
(Mapper.depth_oracle) and features are the raw image, so everything
measured is estimator error.

  python -m sage_slam_tpu_torch.eval.gt_probe --out gt_probe.json

The flags are the JAX CLI's plus ``--device`` (default: the current CUDA
device; without CUDA the CLI raises unless ``--device cpu`` is given).
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def _se3_of(mat4, device):
    import torch

    from ..geometry.se3 import SE3

    return SE3(torch.as_tensor(np.asarray(mat4[:3, :3], np.float32), device=device),
               torch.as_tensor(np.asarray(mat4[:3, 3], np.float32), device=device))


def build_gt_map(cfg, data, stride: int = 4, back: int = 2, device=None):
    """SlamSystem whose keyframes sit at EXACT GT poses with oracle depth
    and raw-image features; the factor graph built as the pipeline would
    (enqueue_keyframe with back-connections both ways) -> (system,
    keyframe ids, keyframe frame indices)."""
    from .error_budget import build_system

    system = build_system(cfg, data, depth_mode="oracle", feat_mode="image", device=device)
    mapper = system.mapper
    frames = list(range(0, data.n, stride))
    h_in, w_in = cfg.net_input_size
    imgs = {i: data.render(i, h_in, w_in)[0] for i in frames}
    mapper.init_one_frame(float(frames[0]), imgs[frames[0]])
    # undo the median-depth gauge normalisation: this probe injects GT
    # poses in WORLD units, so the oracle depth stays in world units too
    # (the store is written in place)
    mapper.store.variables.scale[0] = 1.0
    mapper._init_scale_target = {0: 1.0}
    kf_ids = [0]
    kf_ts = [frames[0]]
    for i in frames[1:]:
        fr = mapper.build_frame(float(i), imgs[i], pose=_se3_of(data.pose_at(i), mapper.device))
        conns = [kf_ids[-k] for k in range(1, min(back, len(kf_ids)) + 1)]
        kf_ids.append(mapper.enqueue_keyframe(fr, conns))
        kf_ts.append(i)
    return system, kf_ids, kf_ts


def _problem_subsets(problem):
    """(label, problem-with-only-that-term) pairs."""
    import torch

    def zero(t):
        return t._replace(valid=torch.zeros_like(t.valid))

    def zero_priors(pr):
        z = torch.zeros_like(pr.code_valid)
        return pr._replace(code_valid=z, scale_valid=z, pose_valid=z)

    out = [("total", problem)]
    out.append(("photo", problem._replace(
        geo_edges=zero(problem.geo_edges), priors=zero_priors(problem.priors), reproj_edges=None,
    )))
    out.append(("geo", problem._replace(
        photo_edges=zero(problem.photo_edges), priors=zero_priors(problem.priors), reproj_edges=None,
    )))
    if problem.reproj_edges is not None and problem.reproj_edges.i0.shape[0]:
        out.append(("reproj", problem._replace(
            photo_edges=zero(problem.photo_edges), geo_edges=zero(problem.geo_edges),
            priors=zero_priors(problem.priors),
        )))
    out.append(("priors", problem._replace(
        photo_edges=zero(problem.photo_edges), geo_edges=zero(problem.geo_edges), reproj_edges=None,
    )))
    return out


def _active_problem(mapper):
    """The full graph of the active keyframes and their variables (copies
    of the store's rows)."""
    from ..geometry.se3 import SE3
    from ..solver import ba
    from ..solver.graph import Variables

    n = mapper.store.num_active
    problem = ba.prepare_problem(mapper.build_problem(), mapper.cam_pyr)
    problem = ba.slice_problem_keyframes(problem, n, mapper.cam_pyr)
    with mapper.store.lock:
        v = mapper.store.snapshot()[2]
    variables = Variables(SE3(v.pose.rot[:n], v.pose.trans[:n]), v.code[:n], v.scale[:n])
    return problem, variables


def grad_report(system) -> dict:
    """Per-term (error, gradient RMS by variable class) at the CURRENT
    store state (GT if called right after build_gt_map): one linearize per
    term subset of the same problem."""
    from ..solver import ba

    mapper = system.mapper
    n = mapper.store.num_active
    problem, variables = _active_problem(mapper)
    cs = variables.code_size
    report = {}
    for label, prob in _problem_subsets(problem):
        _, b, err = ba.linearize(variables, prob, mapper.cam_pyr, mapper.cfg.mapper)
        b = b.cpu().numpy().reshape(n, -1)
        report[label] = dict(
            error=float(err),
            grad_rot_rms=float(np.sqrt((b[:, 0:3] ** 2).mean())),
            grad_trans_rms=float(np.sqrt((b[:, 3:6] ** 2).mean())),
            grad_code_rms=float(np.sqrt((b[:, 6 : 6 + cs] ** 2).mean())),
            grad_scale_rms=float(np.sqrt((b[:, 6 + cs] ** 2).mean())),
        )
    return report


def walk_report(system, data, kf_ts, refine_rounds: int = 12) -> dict:
    """Run the final-refinement loop from GT; report where it lands."""
    from . import ate

    mapper = system.mapper
    for _ in range(refine_rounds):
        mapper.mapping_step(full=True)
        if mapper.last_step_converged:
            break
    n = mapper.store.num_active
    est = np.stack([mapper.store.pose(i).trans.cpu().numpy() for i in range(n)])
    gt = np.stack([data.pose_at(t)[:3, 3] for t in kf_ts])
    span = float(np.linalg.norm(gt.max(0) - gt.min(0)))
    v = mapper.store.variables
    scales = v.scale[:n].cpu().numpy()
    codes = v.code[:n].cpu().numpy()
    rms = float(ate.ate_rmse(est, gt, align="sim3"))
    per_kf = np.linalg.norm(est - gt, axis=-1)  # unaligned, gauge-fixed
    return dict(
        keyframes=n,
        span=round(span, 5),
        kf_ate_sim3=round(rms, 6),
        kf_ate_sim3_pct=round(100 * rms / span, 3),
        kf_trans_err_raw=[round(float(e), 5) for e in per_kf],
        scale_min=round(float(scales.min()), 5),
        scale_max=round(float(scales.max()), 5),
        scale_rel_spread_pct=round(100 * float(scales.max() / scales.min() - 1.0), 3),
        code_norm_max=round(float(np.abs(codes).max()), 5),
    )


def section_report(system, kf: int, span: float = 0.02, steps: int = 21) -> dict:
    """1D cost sections through the CURRENT state along keyframe ``kf``'s
    camera-frame x/y/z translation and its rotation axes, per term; reports
    each term's argmin offset (fraction of ``span``)."""
    import torch

    from ..geometry.se3 import SE3, so3_exp
    from ..solver import ba

    mapper = system.mapper
    problem, variables = _active_problem(mapper)
    subsets = _problem_subsets(problem)
    dev = variables.scale.device
    rot0, trans0 = variables.pose.rot[kf], variables.pose.trans[kf]

    def perturbed(axis, t):
        if axis < 3:
            d = torch.zeros(3, device=dev)
            d[axis] = t
            new = SE3(rot0, trans0 + rot0 @ d)
        else:
            w = torch.zeros(3, device=dev)
            w[axis - 3] = t
            new = SE3(rot0 @ so3_exp(w), trans0)
        rot, trans = variables.pose.rot.clone(), variables.pose.trans.clone()
        rot[kf], trans[kf] = new.rot, new.trans
        return variables._replace(pose=SE3(rot, trans))

    ts = np.linspace(-span, span, steps)
    out = {}
    axis_names = ["tx", "ty", "tz", "rx", "ry", "rz"]
    for axis in range(6):
        scale = 1.0 if axis < 3 else span * 12.5  # rad sweep ~ matched
        for label, prob in subsets:
            if label == "priors":
                continue
            costs = [
                float(ba.total_error(perturbed(axis, float(t * scale)), prob, mapper.cam_pyr,
                                     mapper.cfg.mapper))
                for t in ts
            ]
            k = int(np.argmin(costs))
            out[f"{axis_names[axis]}:{label}"] = dict(
                argmin_frac=round(float(ts[k] / span), 3),
                curvature_ok=bool(0 < k < steps - 1),
                cost_drop_pct=round(
                    100 * (costs[steps // 2] - costs[k]) / max(abs(costs[steps // 2]), 1e-12), 4
                ),
            )
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default="gt_probe.json")
    p.add_argument("--num_frames", type=int, default=64)
    p.add_argument("--height", type=int, default=64)
    p.add_argument("--width", type=int, default=80)
    p.add_argument("--stride", type=int, default=4)
    p.add_argument("--back", type=int, default=2)
    p.add_argument("--orbit_radius", type=float, default=0.22)
    p.add_argument("--rot_amp", type=float, default=0.25)
    p.add_argument("--mask_margin", type=int, default=6)
    p.add_argument("--section_kf", type=int, default=-1)
    p.add_argument("--skip_walk", action="store_true")
    p.add_argument("--skip_section", action="store_true")
    p.add_argument("--refine_rounds", type=int, default=12)
    # estimator-floor sweep levers (defaults = reference parity values)
    p.add_argument("--geo_weight", type=float, default=None)
    p.add_argument("--geo_lp_factor", type=float, default=None)
    p.add_argument("--photo_weights", type=str, default=None, help="comma list, finest level first")
    p.add_argument("--device", default=None, help="torch device (default: the current CUDA device)")
    args = p.parse_args(argv)

    import dataclasses

    from ..config import SlamConfig
    from ..device import resolve_device
    from ..io.dataset import Bowl3DInterface

    dev = resolve_device(args.device)
    data = Bowl3DInterface(
        num_frames=args.num_frames, height=args.height, width=args.width,
        seed=0, orbit_radius=args.orbit_radius, rot_amp=args.rot_amp,
        mask_margin=args.mask_margin,
    )
    cfg = SlamConfig(
        net_input_size=(args.height, args.width),
        net_output_size=(args.height // 2, args.width // 2),
        max_keyframes=max(32, args.num_frames // args.stride + 2),
    )
    over = {}
    if args.geo_weight is not None:
        over["geo_factor_weight"] = args.geo_weight
    if args.geo_lp_factor is not None:
        over["geo_loss_param_factor"] = args.geo_lp_factor
    if args.photo_weights is not None:
        over["photo_factor_weights"] = tuple(float(x) for x in args.photo_weights.split(","))
    if over:
        cfg = dataclasses.replace(cfg, mapper=dataclasses.replace(cfg.mapper, **over))
    system, kf_ids, kf_ts = build_gt_map(cfg, data, args.stride, args.back, device=dev)
    report = {"config": vars(args), "keyframes": len(kf_ids)}
    report["grad_at_gt"] = grad_report(system)
    print("grad_at_gt", json.dumps(report["grad_at_gt"]), flush=True)
    if not args.skip_section:
        kf = args.section_kf if args.section_kf >= 0 else len(kf_ids) // 2
        report["sections_at_gt"] = section_report(system, kf)
        print("sections_at_gt", json.dumps(report["sections_at_gt"]), flush=True)
    if not args.skip_walk:
        report["walk_from_gt"] = walk_report(system, data, kf_ts, args.refine_rounds)
        print("walk_from_gt", json.dumps(report["walk_from_gt"]), flush=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    print(f"wrote {args.out}")
    return report


if __name__ == "__main__":
    main()
