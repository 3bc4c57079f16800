"""Where the time of the mapper's frame build and steady-state step goes.

    python -m sage_slam_tpu_torch.profile_mapper [--keyframes 12] [--trace DIR]

Builds the mapper at the published widths (SlamConfig(), DepthNetConfig(),
FeatureNetConfig(), random weights from a seeded generator) on
synthetic.mapper_scene, grows it to ``--keyframes`` keyframes (back
connections to the previous 3, one mapping_step after each), then reports
host-clock ms, each ending in torch.cuda.synchronize(), means of 5 after
warm-up, for the layers of the two entry points:

* build_frame: the two networks, the pyramid and sampling tables (the
  rest of build_frame), the store write of one frame;
* mapping_step: the compact gather (edge selection, tables of the
  incident keyframes, under the lock), run_ba on it, the whole step;

and a torch.profiler trace of one build_frame and one mapping_step: device
time summed over kernels, busy share (an upper bound: overlapping kernels
count twice), kernel launches, and the top kernels by device time. With
``--trace DIR`` the Chrome traces are written there. Needs a CUDA device;
prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import time

import torch


def _host_ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return sum(out) / len(out), out


def _profile(label, fn, card, trace_dir, warmup: bool = True):
    from torch.profiler import ProfilerActivity, profile

    if warmup:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in events)
    print(f"profiled {label} [{card}]: wall {wall_ms:.3f} ms, device time {device_us / 1e3:.3f} ms "
          f"summed over {sum(e.count for e in events)} kernel launches, busy share <= "
          f"{device_us / 1e3 / wall_ms:.4f}", flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, f"{label.replace(' ', '_')}.json"))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--keyframes", type=int, default=12, help="keyframes before the measured step")
    ap.add_argument("--trace", default=None, help="directory for the Chrome traces")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_mapper needs a CUDA device")
    from .config import SlamConfig
    from .geometry.camera import CameraPyramid
    from .geometry.se3 import SE3
    from .mapping.mapper import Mapper
    from .models import depth_network, feature_network
    from .solver import ba
    from .synthetic import mapper_scene

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"card: {card}", flush=True)
    cfg = SlamConfig()
    scene = mapper_scene(args.keyframes + 1, seed=0)
    gen = torch.Generator().manual_seed(0)
    mapper = Mapper(
        cfg, CameraPyramid.build(scene.camera, cfg.pyramid_levels), scene.mask_out,
        depth_network.init_network(gen, depth_network.DepthNetConfig()),
        feature_network.init_network(gen, feature_network.FeatureNetConfig()),
        video_mask_in=scene.mask_in,
    )
    dev = mapper.device
    images = torch.from_numpy(scene.images).to(dev)
    mapper.init_one_frame(0.0, images[0])
    for f in range(1, args.keyframes):
        pose = SE3(torch.from_numpy(scene.rot[f]).to(dev), torch.from_numpy(scene.trans[f]).to(dev))
        n = mapper.store.num_active
        mapper.enqueue_keyframe(mapper.build_frame(0.1 * f, images[f], pose=pose),
                                list(range(n - 1, max(-1, n - 4), -1)))
        mapper.mapping_step()
    print(f"{mapper.store.num_active} keyframes, last step: E photo/geo "
          f"{mapper.last_step_edges[0]}/{mapper.last_step_edges[1]}, "
          f"{mapper.last_step_iters} iterations", flush=True)

    image = images[-1]
    fr = mapper.build_frame(0.1 * args.keyframes, image)
    store = mapper.store
    snap_n, _, snap_vars = store.snapshot()
    compact = mapper._compact_step_inputs(snap_n, snap_vars, False)
    problem, v_c, update_mask = compact[:3]

    def write_row():
        """One frame's in-place row writes; the row is then dropped again."""
        store.num_active = store._add_locked(fr)
        store.timestamps.pop()

    layers = (
        ("build_frame: networks", lambda: mapper._networks(image)),
        ("build_frame: whole", lambda: mapper.build_frame(0.1 * args.keyframes, image)),
        ("store write of one frame", write_row),
        ("mapping_step: compact gather", lambda: mapper._compact_step_inputs(snap_n, snap_vars, False)),
        ("mapping_step: run_ba", lambda: ba.run_ba(v_c, problem, mapper.cam_pyr, cfg.mapper,
                                                   update_mask, cfg.mapper.max_gn_iters)),
    )
    for label, fn in layers:
        mean, runs = _host_ms(fn)
        print(f"host ms [{card}] {label}: {mean:.3f} (runs {', '.join(f'{r:.3f}' for r in runs)})",
              flush=True)
    _profile("build_frame", lambda: mapper.build_frame(0.1 * args.keyframes, image), card, args.trace)
    _profile("mapping_step", mapper.mapping_step, card, args.trace)


if __name__ == "__main__":
    main()
