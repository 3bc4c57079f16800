"""Full-resolution evaluation artifact generator (port of
sage_slam_tpu/demo/make_eval.py).

One chain at the reference operating point (net in 128x160 / out 64x80,
CS=FS=16, 3072 photometric samples, 4 pyramid levels):

  1. train the full-size networks on two Bowl3D orbits (triplet pipeline,
     separate-phase curriculum),
  2. export runtime checkpoints (npz + netcfg sidecar),
  3. build a BoW vocabulary from the TRAINED descriptors (voc_builder),
  4. run the threaded demo CLI on a held-out orbit with an exact revisit
     (a loop-closure opportunity), loading the trained networks,
  5. evaluate: Sim3-ATE, per-keyframe depth RMSE against the analytic
     ground truth,
  6. fuse the saved keyframe depths into a TSDF volume, extract a
     marching-tetrahedra mesh (PLY) and render a fly-through,
  7. write EVAL.md and report.json into --out_dir.

Each step is a function that takes the widths as arguments (defaults:
make_eval's); ``run`` calls them in order and returns (report, the SLAM
system of step 4). The flags are the JAX CLI's plus ``--device`` (default:
the current CUDA device; without CUDA the CLI raises unless ``--device
cpu`` is given). The default output directory is the git-ignored
``_runs/make_eval``, never the JAX reference's ``eval_artifacts``.

  python -m sage_slam_tpu_torch.demo.make_eval --out_dir _runs/make_eval --separate_only
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
from collections import Counter
from typing import List, NamedTuple

import numpy as np

IN_HW = (128, 160)
OUT_HW = (64, 80)


def training_orbits(train_frames: int, in_hw=IN_HW):
    """The two Bowl3D training orbits. They BRACKET the held-out eval
    orbit's pose range (radius 0.22 / rot 0.25): trained on one tighter
    orbit, the depth prior generalised poorly to held-out views."""
    train_bowl = dict(num_frames=train_frames, height=in_hw[0], width=in_hw[1], seed=0,
                      orbit_radius=0.16, rot_amp=0.15, mask_margin=6)
    return train_bowl, dict(train_bowl, orbit_radius=0.28, rot_amp=0.3)


def eval_orbit(eval_frames: int, in_hw=IN_HW) -> dict:
    """The held-out orbit, which ends where it started (exact revisit)."""
    return dict(num_frames=eval_frames, height=in_hw[0], width=in_hw[1], seed=0,
                orbit_radius=0.22, rot_amp=0.25, mask_margin=6)


def bowl_url(bowl: dict) -> str:
    return "bowl3d://?" + "&".join(f"{k}={v}" for k, v in bowl.items())


def build_triplets(train_frames: int, train_triplets: int, in_hw=IN_HW, out_hw=OUT_HW) -> list:
    """Step 1a: train_triplets // 2 triplets from each training orbit,
    interleaved so that the held-out tail of the list holds both."""
    from ..io.dataset import Bowl3DInterface
    from ..training import dataset as tds

    cfg_t = tds.TripletConfig(num_keypoints=128, frame_interval=3, far_frame_interval=10,
                              use_rotation_aug=False)
    triplets = []
    for si, tb in enumerate(training_orbits(train_frames, in_hw)):
        src = tds.ArraySequenceDataset(Bowl3DInterface(**tb).to_arrays(), cfg=cfg_t,
                                       out_hw=tuple(out_hw), in_hw=tuple(in_hw), seed=si)
        triplets += [src.sample() for _ in range(train_triplets // 2)]
    half = len(triplets) // 2
    return [t for pair in zip(triplets[:half], triplets[half:]) for t in pair]


def train_networks(triplets, out_dir: str, epochs: int, separate_only: bool, plateau_patience: int,
                   train_budget_s: float, out_hw=OUT_HW, depth_cfg=None, feat_cfg=None, device=None):
    """Step 1b: the two-phase curriculum (separate until plateau, then
    joint diff-BA training with the stabilisers), or separate only ->
    (state, the report's "training" entry, depth_cfg, feat_cfg). The state
    is train()'s best-eval snapshot of the final phase."""
    from ..models import depth_network, feature_network
    from ..training import discriminator, train

    depth_cfg = depth_cfg or depth_network.DepthNetConfig(basis_inner=((128, 128, 16),))
    feat_cfg = feat_cfg or feature_network.FeatureNetConfig()
    disc_cfg = discriminator.DiscConfig(img_height=out_hw[0], img_width=out_hw[1])
    tcfg = train.TrainConfig(
        pyramid_levels=4, ba_iters=2, num_photo_samples=128,
        separate_train_epoch=999 if separate_only else 40, eval_fraction=0.2, cycle_steps=200,
    )
    t0 = time.time()
    state, history = train.train(
        triplets, triplets[0].camera, depth_cfg, feat_cfg, disc_cfg, tcfg,
        num_epochs=epochs, seed=0, log_path=os.path.join(out_dir, "train_scalars.jsonl"),
        plateau_patience=plateau_patience, time_budget_s=train_budget_s, device=device,
    )
    # the exported state is the final phase's last snapshot, not
    # necessarily the last epoch nor the raw history minimum
    snap = [h for h in history if h.get("snapshotted") and h["joint"] == history[-1]["joint"]]
    best_h = snap[-1] if snap else history[-1]

    def rounded(h):
        return {k: round(float(v), 4) for k, v in h["eval"].items()}

    training = {
        "epochs": epochs,
        "steps": int(state.step),
        "wall_s": round(time.time() - t0, 1),
        "eval_first": rounded(history[0]),
        "eval_last": rounded(history[-1]),
        "eval_best": rounded(best_h),
        "best_epoch": best_h["epoch"],
    }
    return state, training, depth_cfg, feat_cfg


def export_networks(state, out_dir: str, depth_cfg, feat_cfg) -> dict:
    """Step 2: net_{depth,feat,disc,ba}.npz and net_netcfg.json -> paths."""
    from ..training import export

    return export.export_networks(state, os.path.join(out_dir, "net"), depth_cfg=depth_cfg,
                                  feat_cfg=feat_cfg)


def build_vocabulary(out_dir: str, train_bowl: dict, feat_path: str, device) -> str:
    """Step 3: the BoW vocabulary of the trained descriptors over the first
    training orbit (voc_builder) -> its path."""
    from . import voc_builder

    voc_path = os.path.join(out_dir, "bow_voc.npz")
    voc_builder.main([
        "--source_url", bowl_url(train_bowl), "--output", voc_path, "--k", "8", "--levels", "3",
        "--points_per_frame", "300", "--max_frames", str(train_bowl["num_frames"]),
        "--feat_checkpoint", feat_path, "--device", str(device),
    ])
    return voc_path


def slam_config(max_keyframes: int, in_hw=IN_HW, out_hw=OUT_HW):
    """The demo's SlamConfig. The reference's global_active_window=10
    assumes hundreds of keyframes; a ~15-keyframe demo needs a smaller
    temporal exclusion for a revisit to qualify at all."""
    from ..config import LoopConfig, SlamConfig

    return SlamConfig(net_input_size=tuple(in_hw), net_output_size=tuple(out_hw),
                      max_keyframes=max_keyframes, loop=LoopConfig(global_active_window=6))


def run_demo(out_dir: str, paths: dict, voc_path: str, eval_bowl: dict, cfg, device):
    """Step 4: the threaded demo CLI on the held-out orbit with the trained
    networks and vocabulary -> (summary, the SlamSystem, run directory)."""
    from . import run_slam

    cfg_path = os.path.join(out_dir, "slam_config.json")
    cfg.to_json(cfg_path)
    run_dir = os.path.join(out_dir, "slam_run")
    summary, system = run_slam.run([
        "--source_url", bowl_url(eval_bowl), "--config", cfg_path, "--run_log_dir", run_dir,
        "--max_frames", str(eval_bowl["num_frames"]), "--depth_checkpoint", paths["depth"],
        "--feat_checkpoint", paths["feat"], "--net_config", paths["netcfg"],
        "--vocab_path", voc_path, "--save_keyframes", "--device", str(device),
    ])
    return summary, system, run_dir


class Keyframes(NamedTuple):
    """The saved keyframes of a run: (rot, trans) float64 from the TUM
    file, depth maps [h, w], the output-resolution mask and camera."""

    poses: List[tuple]
    depths: List[np.ndarray]
    mask: np.ndarray
    cam: object


def evaluate(run_dir: str, eval_bowl: dict, out_hw=OUT_HW):
    """Step 5: frame and keyframe Sim3/SE3-ATE and per-keyframe
    scale-aligned depth RMSE against the analytic ground truth, from the
    files the run saved -> (the report's "ate" and "depth" entries,
    Keyframes)."""
    from ..eval import ate
    from ..io import tum_io
    from ..io.dataset import Bowl3DInterface

    h_out, w_out = out_hw
    data = Bowl3DInterface(**eval_bowl)
    traj = tum_io.read_tum(os.path.join(run_dir, "trajectory.txt"))
    est = np.stack([t for _, t, _ in traj])
    gt = np.stack([data.pose_at(i)[:3, 3] for i in range(len(traj))])
    err_sim3 = ate.ate_rmse(est, gt, align="sim3")
    err_se3 = ate.ate_rmse(est, gt, align="se3")
    span = float(np.linalg.norm(gt.max(0) - gt.min(0)))
    ate_report = {
        "sim3_rmse": round(float(err_sim3), 5),
        "se3_rmse": round(float(err_se3), 5),
        "trajectory_span": round(span, 5),
        "sim3_pct_of_span": round(100 * float(err_sim3) / span, 2),
        "frames": len(traj),
    }
    # keyframe poses reflect BA + loop closure + the final refinement
    kf_traj = tum_io.read_tum(os.path.join(run_dir, "keyframe_trajectory.txt"))
    kf_est = np.stack([t for _, t, _ in kf_traj])
    kf_gt = np.stack([data.pose_at(int(ts))[:3, 3] for ts, _, _ in kf_traj])
    ate_report["kf_sim3_rmse"] = round(float(ate.ate_rmse(kf_est, kf_gt, align="sim3")), 5)
    ate_report["kf_sim3_pct_of_span"] = round(100 * ate_report["kf_sim3_rmse"] / span, 2)

    mask = data.mask(h_out, w_out)
    rmses, depths, poses = [], [], []
    for i, (ts, trans, rot) in enumerate(kf_traj):
        est_d = np.load(os.path.join(run_dir, f"kf_{i:04d}_depth.npy"))
        _, gt_d, _ = data.render(int(ts), h_out, w_out)
        rmses.append(ate.depth_rmse(est_d, gt_d, mask, align_scale=True))
        depths.append(est_d)
        poses.append((rot, trans))
    depth_report = {
        "mean_kf_rmse": round(float(np.mean(rmses)), 5),
        "max_kf_rmse": round(float(np.max(rmses)), 5),
        "keyframes": len(rmses),
        "est_depth_range_masked": [
            round(float(min((d * mask).min() for d in depths)), 3),
            round(float(max((d * mask).max() for d in depths)), 3),
        ],
    }
    cam = data.intrinsics().resized(w_out, h_out)
    return ate_report, depth_report, Keyframes(poses, depths, mask, cam)


def fusion_bounds(kf: Keyframes, dims=(96, 96, 96)):
    """(origin, voxel size) of the volume: the keyframe positions padded
    by the median depth."""
    centers = np.stack([t for (_, t) in kf.poses])
    med = float(np.median(np.concatenate([d.reshape(-1) for d in kf.depths])))
    lo = centers.min(0) - 0.5 * med
    hi = centers.max(0) + 2.0 * med
    return lo, float(np.max(hi - lo) / max(dims))


def fuse(kf: Keyframes, dims=(96, 96, 96), device=None):
    """Step 6a: the saved keyframe depths fused into a TSDF volume on
    ``device``."""
    import torch

    from ..eval import tsdf
    from ..geometry.se3 import SE3

    lo, voxel = fusion_bounds(kf, dims)
    vol = tsdf.TSDFVolume.create(lo, dims, voxel, device=device)
    for (rot, trans), d in zip(kf.poses, kf.depths):
        pose = SE3(torch.as_tensor(rot, dtype=torch.float32), torch.as_tensor(trans, dtype=torch.float32))
        vol = tsdf.integrate(vol, d, kf.mask, pose, kf.cam)
    return vol


def write_mesh(out_dir: str, vol) -> dict:
    """Step 6b: marching tetrahedra -> reconstruction.ply; the report's
    "mesh" entry."""
    from ..eval import tsdf

    verts, faces = tsdf.marching_tetrahedra(vol)
    mesh_path = os.path.join(out_dir, "reconstruction.ply")
    tsdf.save_ply(mesh_path, verts, faces)
    return {"vertices": int(len(verts)), "faces": int(len(faces)),
            "path": os.path.relpath(mesh_path, out_dir)}


def render_fly_through(out_dir: str, vol, kf: Keyframes):
    """Step 6c: fly-through PNGs along the keyframe trajectory -> the
    frame count, or None when PIL is missing (the only failure skipped)."""
    import torch

    from ..eval import tsdf
    from ..geometry.se3 import SE3

    try:
        from PIL import Image
    except ImportError:
        print("fly-through skipped: PIL is not installed")
        return None
    way = [SE3(torch.as_tensor(r, dtype=torch.float32), torch.as_tensor(t, dtype=torch.float32))
           for (r, t) in kf.poses]
    fly = tsdf.fly_through(vol, kf.cam, way, num_frames=8, point_size=2)
    fly_dir = os.path.join(out_dir, "fly_through")
    os.makedirs(fly_dir, exist_ok=True)
    for i, img in enumerate(fly):
        Image.fromarray(img).save(os.path.join(fly_dir, f"fly_{i:02d}.png"))
    return len(fly)


def backend_name(device) -> str:
    """The device the chain ran on: the card's name and power limit as
    nvidia-smi reports them, or the device type."""
    import torch

    if device.type != "cuda":
        return device.type
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        )
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError) as e:
        return f"{torch.cuda.get_device_name(device)} (power limit not read: {e})"


def write_eval_md(out_dir: str, report: dict, train_triplets: int, train_frames: int,
                  eval_frames: int, url_eval: str) -> None:
    """Step 7: EVAL.md from the report."""
    tr, op = report["training"], report["operating_point"]
    (h_in, w_in), (h_out, w_out) = op["net_input"], op["net_output"]
    md = f"""# EVAL — end-to-end artifact of the PyTorch/CUDA port

One chain at the operating point in {h_in}x{w_in} / out {h_out}x{w_out},
CS={op['code_size']}, FS={op['feat_size']}, {op['pho_num_samples']} photometric
samples, {op['pyramid_levels']} pyramid levels: the Bowl3D analytic scene
provides exact ground-truth poses and depths.

Backend: **{op['backend']}**. Regenerate with
`python -m sage_slam_tpu_torch.demo.make_eval --out_dir {out_dir}`.

## 1. Training (learned priors)

Partial-conv U-Nets trained on {train_triplets} triplets from two
{train_frames}-frame orbits ({tr['steps']} SGD steps, {tr['wall_s']}s):

| eval loss | first epoch | exported epoch ({tr['best_epoch']}) | last epoch |
|---|---|---|---|
| depth (SI-log) | {tr['eval_first']['depth']} | {tr['eval_best']['depth']} | {tr['eval_last']['depth']} |
| rr (descriptor) | {tr['eval_first']['rr']} | {tr['eval_best']['rr']} | {tr['eval_last']['rr']} |
| total | {tr['eval_first']['loss']} | {tr['eval_best']['loss']} | {tr['eval_last']['loss']} |

The exported state is the best-eval snapshot (epoch {tr['best_epoch']});
"last epoch" is where training stopped.

## 2. SLAM run (threaded demo CLI, trained nets + trained vocabulary)

Held-out orbit ({eval_frames} frames, exact revisit at the end):
`{url_eval}`. Its pose range lies between the two training orbits
(0.16/0.15 and 0.28/0.30); its exact poses are never trained on.

```json
{json.dumps(report['slam'], indent=2)}
```

## 3. Trajectory accuracy (vs analytic GT)

| metric | value |
|---|---|
| Sim3-aligned ATE RMSE (frames, finalized) | {report['ate']['sim3_rmse']} |
| Sim3-aligned ATE RMSE (keyframes, after BA+loops+refine) | {report['ate']['kf_sim3_rmse']} ({report['ate']['kf_sim3_pct_of_span']}% of span) |
| SE3-aligned ATE RMSE | {report['ate']['se3_rmse']} |
| trajectory span | {report['ate']['trajectory_span']} |
| Sim3 ATE / span | {report['ate']['sim3_pct_of_span']}% |

## 4. Depth accuracy (per-keyframe, scale-aligned)

| metric | value |
|---|---|
| mean keyframe depth RMSE | {report['depth']['mean_kf_rmse']} |
| max keyframe depth RMSE | {report['depth']['max_kf_rmse']} |
| keyframes | {report['depth']['keyframes']} |

## 5. Reconstruction

TSDF fusion of the saved keyframe depths -> marching-tetrahedra mesh:
`{report['mesh']['path']}` ({report['mesh']['vertices']} vertices,
{report['mesh']['faces']} faces).

## Files

- `slam_run/trajectory.txt`, `slam_run/keyframe_trajectory.txt` — TUM
- `slam_run/kf_*.npy` — keyframe depth maps
- `net_depth.npz`, `net_feat.npz`, `net_netcfg.json` — trained nets
- `bow_voc.npz` — trained BoW vocabulary
- `reconstruction.ply` — fused mesh
- `report.json` — everything above, machine-readable
"""
    with open(os.path.join(out_dir, "EVAL.md"), "w") as f:
        f.write(md)


def run(argv=None, depth_cfg=None, feat_cfg=None, in_hw=IN_HW, out_hw=OUT_HW):
    """The CLI's body -> (report, the SlamSystem of the demo run). The
    keywords (network configs, widths) default to make_eval's; the CLI
    passes none."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out_dir", default=os.path.join("_runs", "make_eval"))
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--train_triplets", type=int, default=48)
    p.add_argument("--train_frames", type=int, default=64)
    p.add_argument("--eval_frames", type=int, default=64)
    p.add_argument("--max_keyframes", type=int, default=32)
    # train to a plateau under a wall budget
    p.add_argument("--train_budget_s", type=float, default=6000.0)
    p.add_argument("--plateau_patience", type=int, default=6)
    # the separate-phase-only curriculum, which the JAX package's recorded
    # artifact ships: its joint phase cost depth-prior quality and found
    # no loop candidate downstream
    p.add_argument("--separate_only", action="store_true")
    p.add_argument("--device", default=None, help="torch device (default: the current CUDA device)")
    args = p.parse_args(argv)

    from ..device import resolve_device

    dev = resolve_device(args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    t_all = time.time()
    cfg = slam_config(args.max_keyframes, in_hw, out_hw)
    report = {"operating_point": {
        "net_input": list(cfg.net_input_size), "net_output": list(cfg.net_output_size),
        "code_size": cfg.code_size, "feat_size": cfg.feat_size,
        "pho_num_samples": cfg.mapper.pho_num_samples, "pyramid_levels": cfg.pyramid_levels,
        "backend": backend_name(dev),
    }}

    t0 = time.time()
    triplets = build_triplets(args.train_frames, args.train_triplets, in_hw, out_hw)
    print(f"built {len(triplets)} triplets in {time.time() - t0:.1f}s", flush=True)
    state, report["training"], depth_cfg, feat_cfg = train_networks(
        triplets, args.out_dir, args.epochs, args.separate_only, args.plateau_patience,
        args.train_budget_s, out_hw, depth_cfg, feat_cfg, dev,
    )
    print("training:", json.dumps(report["training"]), flush=True)
    paths = export_networks(state, args.out_dir, depth_cfg, feat_cfg)
    voc_path = build_vocabulary(args.out_dir, training_orbits(args.train_frames, in_hw)[0],
                                paths["feat"], dev)

    eval_bowl = eval_orbit(args.eval_frames, in_hw)
    report["slam"], system, run_dir = run_demo(args.out_dir, paths, voc_path, eval_bowl, cfg, dev)
    gates = Counter(r[2] for r in system.loop_rejections)
    print(f"loop gate rejections: {dict(gates)}", flush=True)

    report["ate"], report["depth"], kf = evaluate(run_dir, eval_bowl, out_hw)
    print("ate:", json.dumps(report["ate"]), flush=True)
    print("depth:", json.dumps(report["depth"]), flush=True)
    vol = fuse(kf, device=dev)
    report["mesh"] = write_mesh(args.out_dir, vol)
    print("mesh:", json.dumps(report["mesh"]), flush=True)
    frames = render_fly_through(args.out_dir, vol, kf)
    if frames is not None:
        report["mesh"]["fly_through_frames"] = frames

    report["wall_total_s"] = round(time.time() - t_all, 1)
    with open(os.path.join(args.out_dir, "report.json"), "w") as f:
        json.dump(report, f, indent=2)
    write_eval_md(args.out_dir, report, args.train_triplets, args.train_frames, args.eval_frames,
                  bowl_url(eval_bowl))
    print(f"EVAL written to {args.out_dir} in {report['wall_total_s']}s")
    return report, system


def main(argv=None):
    """The CLI: runs the chain and returns its report."""
    return run(argv)[0]


if __name__ == "__main__":
    main()
