"""SLAM demo CLI (port of sage_slam_tpu/demo/run_slam.py, the reference's
df_demo).

Usage:
  python -m sage_slam_tpu_torch.demo.run_slam --source_url synthetic:// \\
      --run_log_dir RUN_DIR [--config config.json] [--max_frames N] \\
      [--device cpu]

Loads networks from npz checkpoints when given, runs the threaded driver
over the dataset and writes into the run directory: config.json,
trajectory.txt (the finalized frame poses), trajectory_tracked.txt (as
tracked), keyframe_trajectory.txt (TUM), kf_XXXX_depth.npy per keyframe
with --save_keyframes, a headless map.png (best-effort: skipped with a
message where matplotlib is missing) and summary.json.

The flags are the JAX CLI's plus ``--device`` (default: the current CUDA
device; the CLI raises without CUDA unless ``--device cpu`` is given).
Without checkpoints the networks are randomly initialised from
``torch.Generator().manual_seed(0)``, which draws other weights than the
JAX CLI's ``jax.random.key(0)``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def _resize_nearest(mask: np.ndarray, h: int, w: int) -> np.ndarray:
    ys = (np.arange(h) * mask.shape[0] / h).astype(int)
    xs = (np.arange(w) * mask.shape[1] / w).astype(int)
    return mask[np.ix_(ys, xs)]


def main(argv=None):
    """The CLI: runs the demo and returns its summary dict."""
    return run(argv)[0]


def run(argv=None):
    """The CLI's body -> (summary, the SlamSystem after the run)."""
    # crash diagnostics with native backtraces (the reference installs
    # SIGSEGV/SIGABRT handlers)
    import faulthandler

    faulthandler.enable()

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--source_url", default="synthetic://")
    p.add_argument("--config", default=None, help="SlamConfig json")
    p.add_argument("--depth_checkpoint", default=None)
    p.add_argument("--feat_checkpoint", default=None)
    p.add_argument(
        "--net_config", default=None,
        help="netcfg.json sidecar of a training export (network architectures; "
        "defaults to the reference sizes)",
    )
    p.add_argument("--vocab_path", default=None)
    p.add_argument("--run_log_dir", default="sage_slam_run")
    p.add_argument("--max_frames", type=int, default=None)
    p.add_argument("--skip_frames", type=int, default=0)
    p.add_argument("--enable_timing", action="store_true")
    p.add_argument(
        "--v", type=int, default=0,
        help="verbosity: >=1 enables sage_slam DEBUG logging of loop-closure gate decisions",
    )
    p.add_argument("--no_threads", action="store_true")
    p.add_argument("--save_keyframes", action="store_true")
    p.add_argument("--device", default=None, help="torch device (default: the current CUDA device)")
    args = p.parse_args(argv)

    import torch

    from ..config import SlamConfig
    from ..device import resolve_device
    from ..frontend.driver import SlamDriver
    from ..frontend.slam import SlamSystem
    from ..io import dataset, tum_io
    from ..models import depth_network, feature_network
    from ..utils import timing

    dev = resolve_device(args.device)
    os.makedirs(args.run_log_dir, exist_ok=True)
    timing.enable(args.enable_timing)
    if args.v >= 1:
        import logging

        lg = logging.getLogger("sage_slam")
        lg.setLevel(logging.DEBUG)
        if not lg.handlers:  # repeated main() calls must not duplicate
            h = logging.StreamHandler()
            h.setFormatter(logging.Formatter("%(name)s: %(message)s"))
            lg.addHandler(h)

    cfg = SlamConfig.from_json(args.config) if args.config else SlamConfig()
    # snapshot the config like the reference's flags snapshot
    cfg.to_json(os.path.join(args.run_log_dir, "config.json"))

    if args.source_url.startswith("synthetic://"):
        data = dataset.SyntheticInterface(
            num_frames=args.max_frames or 20,
            height=cfg.net_input_size[0],
            width=cfg.net_input_size[1],
        )
    elif args.source_url.startswith("bowl3d://"):
        # query parameters map onto Bowl3DInterface's keywords (from_url);
        # the defaults follow the CLI's frame limit and the input size
        data = dataset.from_url(
            args.source_url,
            num_frames=args.max_frames or 20,
            height=cfg.net_input_size[0],
            width=cfg.net_input_size[1],
        )
    else:
        data = dataset.from_url(args.source_url)
    h_out, w_out = cfg.net_output_size
    out_cam = data.intrinsics().resized(w_out, h_out)

    depth_cfg = depth_network.DepthNetConfig(basis_inner=((128, 128, cfg.code_size),))
    feat_cfg = feature_network.FeatureNetConfig()
    if args.net_config:
        from ..training.export import load_net_configs

        d_cfg, f_cfg = load_net_configs(args.net_config)
        depth_cfg = d_cfg or depth_cfg
        feat_cfg = f_cfg or feat_cfg
    depth_net = depth_network.init_network(torch.Generator().manual_seed(0), depth_cfg)
    feat_net = feature_network.init_network(torch.Generator().manual_seed(0), feat_cfg)
    if args.depth_checkpoint or args.feat_checkpoint:
        from ..models.partial_unet import load_torch_state_dict

        for net, path in ((depth_net, args.depth_checkpoint), (feat_net, args.feat_checkpoint)):
            if path:
                load_torch_state_dict(net, dict(np.load(path)))

    voc = None
    if args.vocab_path:
        from ..loop import vocabulary

        if args.vocab_path.endswith(".npz"):
            voc = vocabulary.load_npz_vocabulary(args.vocab_path, device=dev)
        else:
            voc = vocabulary.load_dbow2_yaml(args.vocab_path, device=dev)

    # the mask at the output resolution (nearest) and at the networks'
    # input resolution (the partial convolutions' video mask)
    mask_full = data.mask()
    mask_out = _resize_nearest(mask_full, h_out, w_out)
    mask_in = _resize_nearest(mask_full, *cfg.net_input_size)

    system = SlamSystem(cfg, out_cam, mask_out, depth_net, feat_net, voc=voc,
                        video_mask_in=mask_in, device=dev)
    driver = SlamDriver(system, use_native_threads=not args.no_threads)

    t0 = time.time()
    results = driver.run(data, max_frames=args.max_frames)
    dt = time.time() - t0
    n = len(results) + 1

    # trajectory.txt carries the finalized frame poses (re-expressed from
    # the final keyframe poses); the as-tracked poses are kept beside it for
    # drift diagnostics
    tum_io.write_tum(os.path.join(args.run_log_dir, "trajectory.txt"), system.finalized_trajectory())
    tum_io.write_tum(os.path.join(args.run_log_dir, "trajectory_tracked.txt"), system.trajectory)
    tum_io.write_tum(os.path.join(args.run_log_dir, "keyframe_trajectory.txt"),
                     system.keyframe_trajectory())
    if args.save_keyframes and system.store.num_active:
        depths = torch.stack([system.store.depth_map(i) for i in range(system.store.num_active)])
        for i, d in enumerate(depths.cpu().numpy()):
            np.save(os.path.join(args.run_log_dir, f"kf_{i:04d}_depth.npy"), d.reshape(h_out, w_out))
    # headless visualization
    try:
        from ..viz.visualizer import render_map_png

        render_map_png(system, os.path.join(args.run_log_dir, "map.png"))
    except Exception as e:  # noqa: BLE001 - the picture is best-effort
        print(f"visualization skipped: {type(e).__name__}: {e}")

    summary = dict(
        frames=n,
        keyframes=system.store.num_active,
        fps=round(n / dt, 3),
        wall_time_s=round(dt, 2),
        backend=dev.type,
        # refine_mapping's LM iterations until relinearization convergence
        refine_iterations=getattr(system, "refine_iterations", 0),
        global_loops=len(system.store.global_loop_links),
    )
    with open(os.path.join(args.run_log_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary))
    if args.enable_timing:
        print(timing.report())
    return summary, system


if __name__ == "__main__":
    main()
