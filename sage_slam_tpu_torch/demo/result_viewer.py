"""Trajectory / results viewer CLI (port of
sage_slam_tpu/demo/result_viewer.py, the reference's result_viewer).

Loads a TUM trajectory (and optional ground truth), prints summary
statistics and the ATE, and renders a 3D plot to PNG.
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    import faulthandler

    faulthandler.enable()

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("trajectory", help="TUM trajectory file")
    p.add_argument("--ground_truth", default=None)
    p.add_argument("--align", choices=["sim3", "se3", "none"], default="sim3")
    p.add_argument("--plot", default=None, help="output PNG path")
    args = p.parse_args(argv)

    from ..eval import ate
    from ..io import tum_io

    traj = tum_io.read_tum(args.trajectory)
    pos = np.stack([t for _, t, _ in traj])
    print(f"{len(traj)} poses")
    print(f"path length: {np.linalg.norm(np.diff(pos, axis=0), axis=1).sum():.4f}")
    print(f"extent: {pos.max(0) - pos.min(0)}")

    gt = tum_io.read_tum(args.ground_truth) if args.ground_truth else None
    if gt is not None:
        e, g = ate.associate([(ts, p_) for ts, p_, _ in traj], [(ts, p_) for ts, p_, _ in gt], max_dt=0.05)
        if len(e):
            rmse = ate.ate_rmse(e, g, args.align)
            print(f"ATE RMSE ({args.align}): {rmse:.6f} over {len(e)} pairs")
        else:
            print("no associated timestamps")

    if args.plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig = plt.figure(figsize=(8, 6))
        ax = fig.add_subplot(111, projection="3d")
        ax.plot(pos[:, 0], pos[:, 1], pos[:, 2], label="estimate")
        if gt is not None:
            gtp = np.stack([t for _, t, _ in gt])
            ax.plot(gtp[:, 0], gtp[:, 1], gtp[:, 2], label="ground truth")
        ax.legend()
        fig.savefig(args.plot, dpi=110)
        plt.close(fig)
        print(f"plot saved to {args.plot}")


if __name__ == "__main__":
    main()
