"""Per-stage accuracy error budget on the analytic Bowl3D scene (port of
sage_slam_tpu/eval/error_budget.py).

Decomposes trajectory error by stage and by prior quality on a scene with
exact ground truth:

stage axis (cumulative pipeline):
  tracker   — frontend only: tracking + keyframe creation, NO mapping
  window    — + windowed BA after every new keyframe (MappingStep role)
  refine    — + final full-graph refinement (RefineMapping role)
  full      — + local/global loop closure ticks (the complete system)

prior axis:
  depth ∈ {oracle, net}   oracle = analytic GT depth via Mapper.depth_oracle
  feat  ∈ {handcrafted, net}  handcrafted = fixed equivariant bank
                              (models/feature_network.handcrafted_apply)

Run (the flags are the JAX CLI's plus ``--device``; the default is the
current CUDA device, and without CUDA the CLI raises unless ``--device cpu``
is given):

  python -m sage_slam_tpu_torch.eval.error_budget --out error_budget.json

Without checkpoints the networks are randomly initialised from
``torch.Generator().manual_seed(0)``, which draws other weights than the
JAX CLI's ``jax.random.key(0)``; the oracle rows use no network output.
"""

from __future__ import annotations

import argparse
import copy
import json
import time

import numpy as np


def build_system(
    cfg,
    data,
    depth_mode: str = "oracle",
    feat_mode: str = "handcrafted",
    depth_net=None,
    feat_net=None,
    voc=None,
    device=None,
):
    """SlamSystem over a Bowl3DInterface with the requested prior modes.
    The networks default to seeded random ones at the config's code and
    feature sizes; ``"handcrafted"`` and ``"image"`` set the feature mode on
    a copy of the feature network."""
    import torch

    from ..frontend.slam import SlamSystem
    from ..models import depth_network, feature_network

    h_out, w_out = cfg.net_output_size
    out_cam = data.intrinsics().resized(w_out, h_out)
    if depth_net is None:
        depth_net = depth_network.init_network(
            torch.Generator().manual_seed(0),
            depth_network.DepthNetConfig(basis_inner=((128, 128, cfg.code_size),)),
        )
    if feat_net is None:
        feat_net = feature_network.init_network(
            torch.Generator().manual_seed(0),
            feature_network.FeatureNetConfig(
                desc_inner=(64, 64, cfg.feat_size), map_inner=(64, 64, cfg.feat_size)
            ),
        )
    if feat_mode in ("handcrafted", "image"):
        feat_net = copy.deepcopy(feat_net)
        feat_net.cfg = feat_net.cfg._replace(mode=feat_mode)

    h_in, w_in = cfg.net_input_size
    system = SlamSystem(
        cfg, out_cam, data.mask(h_out, w_out), depth_net, feat_net, voc=voc,
        video_mask_in=data.mask(h_in, w_in), device=device,
    )
    if depth_mode == "oracle":
        system.mapper.depth_oracle = lambda ts: data.render(int(round(ts)), h_out, w_out)[1]
    return system


def build_vocabulary_for(data, cfg, feat_net, num_frames=12, points_per_frame=200):
    """A small BoW vocabulary from the sequence's own descriptors (the
    voc_builder tool's role), so that the 'full' stages exercise global
    loop closure; built on the feature network's device."""
    import torch

    from ..loop import vocabulary
    from ..models import feature_network

    dev = next(feat_net.parameters()).device
    h_in, w_in = cfg.net_input_size
    mask_in = torch.as_tensor(data.mask(h_in, w_in), device=dev)[None]
    feats, doc_ids = [], []
    rng = np.random.default_rng(0)
    step = max(1, data.n // num_frames)
    h_out, w_out = cfg.net_output_size
    valid = np.flatnonzero(data.mask(h_out, w_out).reshape(-1) > 0.5)
    for i in range(0, data.n, step):
        img = torch.as_tensor(data.render(i, h_in, w_in)[0], device=dev)
        with torch.no_grad():
            desc = feature_network.apply(feat_net, img, mask_in)[1]
        desc = desc.cpu().numpy().reshape(cfg.feat_size, -1).T
        sel = rng.choice(valid, size=min(points_per_frame, len(valid)), replace=False)
        feats.append(desc[sel])
        doc_ids.append(np.full(len(sel), i))
    return vocabulary.build_vocabulary(
        np.concatenate(feats), k=8, levels=3, seed=0, doc_ids=np.concatenate(doc_ids), device=dev,
    )


def run_stage(system, data, stage: str = "full", refine_iters: int = 8) -> dict:
    """Drive the system deterministically (single-threaded; the threaded
    driver's cadence — mapping after each keyframe, loop ticks per frame —
    is replayed synchronously) and evaluate against the analytic ground
    truth."""
    from . import ate

    h_out, w_out = system.cfg.net_output_size
    frames = list(data.frames())
    t0 = time.time()
    system.bootstrap(frames[0].timestamp, frames[0].image)
    lost = 0
    for rec in frames[1:]:
        res = system.process_frame(rec.timestamp, rec.image)
        lost += int(res.tracking_lost)
        if res.new_keyframe and stage != "tracker":
            system.mapper.mapping_step()
        if stage == "full":
            system.local_loop_tick()
            system.global_loop_tick()
    if stage in ("refine", "full"):
        system.refine_mapping(refine_iters)
    wall = time.time() - t0

    # frame ATE uses the finalized trajectory (frames re-expressed from the
    # BA'd keyframes); the as-tracked ATE is kept as a diagnostic of
    # frontend drift
    est = np.stack([p.trans.cpu().numpy() for _, p in system.finalized_trajectory()])
    est_tracked = np.stack([p.trans.cpu().numpy() for _, p in system.trajectory])
    gt = np.stack([data.pose_at(i)[:3, 3] for i in range(len(frames))])
    span = float(np.linalg.norm(gt.max(0) - gt.min(0)))
    out = dict(
        frames=len(frames),
        keyframes=int(system.store.num_active),
        tracking_lost=lost,
        global_loops=len(system.store.global_loop_links),
        wall_s=round(wall, 1),
        span=round(span, 5),
        ate_sim3=round(float(ate.ate_rmse(est, gt, align="sim3")), 5),
        ate_se3=round(float(ate.ate_rmse(est, gt, align="se3")), 5),
        ate_sim3_tracked=round(float(ate.ate_rmse(est_tracked, gt, align="sim3")), 5),
    )
    out["ate_sim3_pct"] = round(100 * out["ate_sim3"] / span, 2)
    out["ate_sim3_tracked_pct"] = round(100 * out["ate_sim3_tracked"] / span, 2)

    kf_traj = system.keyframe_trajectory()
    if len(kf_traj) >= 3:
        kf_est = np.stack([p.trans.cpu().numpy() for _, p in kf_traj])
        kf_gt = np.stack([data.pose_at(int(round(ts)))[:3, 3] for ts, _ in kf_traj])
        out["kf_ate_sim3"] = round(float(ate.ate_rmse(kf_est, kf_gt, align="sim3")), 5)
        out["kf_ate_sim3_pct"] = round(100 * out["kf_ate_sim3"] / span, 2)

    mask = data.mask(h_out, w_out)
    rmses = []
    for i, (ts, _) in enumerate(kf_traj):
        est_d = system.store.depth_map(i).cpu().numpy().reshape(h_out, w_out)
        gt_d = data.render(int(round(ts)), h_out, w_out)[1]
        rmses.append(ate.depth_rmse(est_d, gt_d, mask, align_scale=True))
    if rmses:
        out["depth_rmse_mean"] = round(float(np.mean(rmses)), 5)
        out["depth_rmse_max"] = round(float(np.max(rmses)), 5)
    return out


DEFAULT_MATRIX = (
    # (label, stage, depth_mode, feat_mode). Oracle rows use the raw
    # "image" feature mode — the unbiased photometric baseline — so they
    # measure the ESTIMATOR. The handcrafted row quantifies the bias a
    # generic filter bank adds; net rows measure the learned priors.
    ("A_tracker_oracle", "tracker", "oracle", "image"),
    ("B_window_oracle", "window", "oracle", "image"),
    ("C_refine_oracle", "refine", "oracle", "image"),
    ("D_full_oracle", "full", "oracle", "image"),
    ("D2_full_handcrafted", "full", "oracle", "handcrafted"),
    ("E_full_netdepth", "full", "net", "image"),
    ("F_full_nets", "full", "net", "net"),
)


def main(argv=None):
    """The CLI: runs the stages and returns the report."""
    return run(argv)[0]


def run(argv=None):
    """The CLI's body -> (report, {label: the stage's SlamSystem})."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default="error_budget.json")
    p.add_argument("--num_frames", type=int, default=32)
    p.add_argument("--height", type=int, default=128)
    p.add_argument("--width", type=int, default=160)
    p.add_argument("--max_keyframes", type=int, default=32)
    p.add_argument("--orbit_radius", type=float, default=0.22)
    p.add_argument("--rot_amp", type=float, default=0.25)
    p.add_argument("--mask_margin", type=int, default=6)
    p.add_argument("--orbits", type=float, default=1.0,
                   help=">1 = multi-revisit trajectory (loop-wins eval)")
    p.add_argument("--geo_weight", type=float, default=None)
    # hard mode: endoscopy-like photometric nuisances (view-dependent light
    # falloff + specular lobe + sensor noise) — io.dataset
    p.add_argument("--light_falloff", type=float, default=0.0)
    p.add_argument("--specular", type=float, default=0.0)
    p.add_argument("--noise", type=float, default=0.0)
    p.add_argument("--stages", default=None, help="comma-separated labels from the default matrix")
    p.add_argument("--depth_checkpoint", default=None)
    p.add_argument("--feat_checkpoint", default=None)
    p.add_argument("--net_config", default=None)
    p.add_argument("--vocab_path", default=None)
    p.add_argument("--device", default=None, help="torch device (default: the current CUDA device)")
    args = p.parse_args(argv)

    import dataclasses

    import torch

    from ..config import LoopConfig, SlamConfig
    from ..device import resolve_device
    from ..io.dataset import Bowl3DInterface

    dev = resolve_device(args.device)
    data = Bowl3DInterface(
        num_frames=args.num_frames, height=args.height, width=args.width,
        seed=0, orbit_radius=args.orbit_radius, rot_amp=args.rot_amp,
        mask_margin=args.mask_margin, orbits=args.orbits,
        light_falloff=args.light_falloff, specular=args.specular, noise=args.noise,
    )
    cfg = SlamConfig(
        net_input_size=(args.height, args.width),
        net_output_size=(args.height // 2, args.width // 2),
        max_keyframes=args.max_keyframes,
        loop=LoopConfig(global_active_window=6),
    )
    if args.geo_weight is not None:
        cfg = dataclasses.replace(
            cfg, mapper=dataclasses.replace(cfg.mapper, geo_factor_weight=args.geo_weight)
        )

    depth_net = feat_net = None
    if args.depth_checkpoint or args.feat_checkpoint:
        from ..models import depth_network, feature_network
        from ..models.partial_unet import load_torch_state_dict

        depth_cfg = feat_cfg = None
        if args.net_config:
            from ..training.export import load_net_configs

            depth_cfg, feat_cfg = load_net_configs(args.net_config)
        if args.depth_checkpoint:
            depth_net = depth_network.init_network(
                torch.Generator().manual_seed(0), depth_cfg or depth_network.DepthNetConfig()
            )
            load_torch_state_dict(depth_net, dict(np.load(args.depth_checkpoint)))
        if args.feat_checkpoint:
            feat_net = feature_network.init_network(
                torch.Generator().manual_seed(0), feat_cfg or feature_network.FeatureNetConfig()
            )
            load_torch_state_dict(feat_net, dict(np.load(args.feat_checkpoint)))
    voc = None
    if args.vocab_path:
        from ..loop.vocabulary import load_npz_vocabulary

        voc = load_npz_vocabulary(args.vocab_path, device=dev)

    wanted = set(args.stages.split(",")) if args.stages else None
    report, systems = {}, {}
    voc_cache = {}
    for label, stage, depth_mode, feat_mode in DEFAULT_MATRIX:
        if wanted is not None and label not in wanted:
            continue
        nets = dict(depth_net=depth_net, feat_net=feat_net, device=dev)
        system = build_system(cfg, data, depth_mode, feat_mode, voc=voc, **nets)
        if stage == "full" and voc is None:
            # global loop closure needs a BoW database; train a small
            # vocabulary from this run's own feature mode
            if feat_mode not in voc_cache:
                voc_cache[feat_mode] = build_vocabulary_for(data, cfg, system.mapper.feat_net)
            system = build_system(cfg, data, depth_mode, feat_mode, voc=voc_cache[feat_mode], **nets)
        report[label] = run_stage(system, data, stage)
        systems[label] = system
        print(label, json.dumps(report[label]), flush=True)

    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    print(f"wrote {args.out}")
    return report, systems


if __name__ == "__main__":
    main()
