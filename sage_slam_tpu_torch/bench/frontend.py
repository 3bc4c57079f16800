"""Frontend latency: ms per tracked frame over a Bowl3D orbit (port of
bench_frontend.py).

    python -m sage_slam_tpu_torch.bench.frontend [--device cpu] [--frames 64]

The video: io.dataset.Bowl3DInterface (``frames`` frames at 128x160, seed
0, orbit_radius 0.22, rot_amp 0.25, mask_margin 6, max(1, frames / 64)
orbits). The system: SlamConfig at that input size (output half of it;
defaults otherwise, as bench_frontend.py) with max(64, frames // 4)
keyframes and LoopConfig(global_active_window=6), built by
eval.error_budget.build_system with its seeded random networks, the
network depth prior and the handcrafted feature mode. Frames are uploaded
before the loop; bootstrap on frame 0, 6 warm-up frames, then every later
frame through SlamSystem.process_frame, synchronised, on the host clock.
No mapping step runs (as in bench_frontend.py), so K1 is not launched.
build_frame is timed by its utils/timing span: CUDA events on the card,
the host clock on the CPU.

Prints, after the device line, bench_frontend.py's lines:
``frontend_ms_per_frame`` (non-keyframe frames), ``frontend_build_frame_ms``,
``frontend_keyframe_overhead_ms`` (when a keyframe was made),
``frontend_fps`` and ``frontend_whole_run_fps``. bench_frontend.py's
``vs_baseline`` is left out: its 240 ms baseline was a measurement on a
TPU, which the port does not state as its own.
"""

from __future__ import annotations

import time

import torch

from ..config import LoopConfig, SlamConfig
from ..device import resolve_device
from ..eval import error_budget
from ..io.dataset import Bowl3DInterface
from ..utils import timing
from . import emit, parser, start, sync

WARMUP = 6


def setup(num_frames: int = 64, height: int = 128, width: int = 160, device=None, depth_net=None,
          feat_net=None):
    """bench_frontend.py's orbit and system -> (SlamSystem, Bowl3DInterface).
    The networks default to build_system's seeded random ones."""
    data = Bowl3DInterface(num_frames=num_frames, height=height, width=width, seed=0,
                           orbit_radius=0.22, rot_amp=0.25, mask_margin=6,
                           orbits=max(1.0, num_frames / 64.0))
    cfg = SlamConfig(net_input_size=(height, width), net_output_size=(height // 2, width // 2),
                     max_keyframes=max(64, num_frames // 4),
                     loop=LoopConfig(global_active_window=6))
    system = error_budget.build_system(cfg, data, "net", "handcrafted", depth_net, feat_net,
                                       device=device)
    return system, data


def run(system, data, warmup: int = WARMUP) -> dict:
    """Bootstrap, ``warmup`` frames, then the timed frames -> {"records":
    the printed lines, "decisions": every processed frame's new_keyframe}."""
    dev = system.device
    frames = list(data.frames())
    system.bootstrap(frames[0].timestamp, torch.as_tensor(frames[0].image, device=dev))
    imgs = [torch.as_tensor(rec.image, device=dev) for rec in frames[1:]]
    sync(dev)
    decisions = []
    for i, img in enumerate(imgs[:warmup], start=1):
        decisions.append(system.process_frame(frames[i].timestamp, img).new_keyframe)
    sync(dev)

    timing.reset()
    timing.enable(True, cuda_events=dev.type == "cuda")
    try:
        n_meas = kf_created = 0
        t_kf = 0.0
        t0 = time.perf_counter()
        for i, img in enumerate(imgs[warmup:], start=1 + warmup):
            t1 = time.perf_counter()
            res = system.process_frame(frames[i].timestamp, img)
            sync(dev)
            dt = time.perf_counter() - t1
            decisions.append(res.new_keyframe)
            if res.new_keyframe:
                kf_created += 1
                t_kf += dt
            else:
                n_meas += 1
        total = time.perf_counter() - t0
        build = timing.calls("build_frame")
    finally:
        timing.enable(False)
        timing.reset()

    per_frame = (total - t_kf) / max(n_meas, 1) * 1000
    build_ms = [dev_ms if dev.type == "cuda" else host_ms for host_ms, dev_ms in build]
    records = [
        {"metric": "frontend_ms_per_frame", "value": round(per_frame, 1), "unit": "ms"},
        {"metric": "frontend_build_frame_ms", "value": round(sum(build_ms) / max(len(build_ms), 1), 1),
         "unit": "ms"},
    ]
    if kf_created:
        records.append({"metric": "frontend_keyframe_overhead_ms",
                        "value": round(t_kf / kf_created * 1000 - per_frame, 1), "unit": "ms",
                        "keyframes": kf_created})
    records += [
        {"metric": "frontend_fps", "value": round(1000.0 / per_frame, 2), "unit": "frames/s"},
        {"metric": "frontend_whole_run_fps", "value": round((n_meas + kf_created) / total, 2),
         "unit": "frames/s", "frames": n_meas + kf_created, "keyframes": kf_created},
    ]
    return {"records": [emit(r) for r in records], "decisions": decisions}


def main(argv=None) -> dict:
    ap = parser(__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=64, help="frames of the orbit")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    start(dev, "frontend")
    system, data = setup(args.frames, device=dev)
    return run(system, data)


if __name__ == "__main__":
    main()
