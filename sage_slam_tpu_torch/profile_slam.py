"""Where the time of the SLAM frontend's frames goes.

    python -m sage_slam_tpu_torch.profile_slam [--frames 24] [--trace DIR]

Builds SlamSystem at the published widths (SlamConfig(), DepthNetConfig(),
FeatureNetConfig(), random weights from a seeded generator) on
synthetic.slam_scene, runs bootstrap on frame 0 and process_frame on every
later frame, with a mapping_step after each new keyframe (every 4th frame is made one),
and reports
host-clock ms per layer of process_frame, each layer ending in
torch.cuda.synchronize():

* build_frame (the networks, pyramid and tables);
* _match_geo (descriptor matching and GNC-TLS registration);
* lm_track, with its LM iterations (coarse plus fine);
* the rest: the metrics, the one batched host read, the hulls and the
  keyframe decision;
* _create_keyframe (the candidates' ratios, the store write and the new
  factors), on keyframe frames;

and the mapping_step that follows a new keyframe. Then a torch.profiler
trace of one tracked frame (a fresh frame processed on a clone of the
state, not kept): device ms by kernel name, launches and the busy share
(an upper bound: overlapping kernels count twice). With ``--trace DIR``
the Chrome trace is written there. Needs a CUDA device; prints the card's
name and power limit first.

``drive`` is also what chip_smoke.py's system phase runs.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import subprocess
import time

import numpy as np
import torch

LAYERS = ("build_frame", "match_geo", "lm_track", "rest", "create_keyframe")
# every n-th frame is made a keyframe whatever its ratios say
# (SlamSystem.force_keyframe, as the JAX package's tests drive it): with
# random networks the tracked motion may never cross the keyframe
# thresholds, and the mapper must run
KEYFRAME_EVERY = 4


def build_system(num_frames: int, device=None, scene=None, voc=None, cfg=None):
    """(SlamSystem, scene, cfg) at the published widths: ``cfg`` defaults
    to SlamConfig(), ``scene`` to slam_scene's ``num_frames`` frames;
    ``voc`` (a loop.vocabulary.Vocabulary) enables the BoW database."""
    from . import synthetic
    from .config import SlamConfig
    from .frontend.slam import SlamSystem
    from .models import depth_network, feature_network

    cfg = cfg or SlamConfig()
    if scene is None:
        scene = synthetic.slam_scene(num_frames, seed=0, height=cfg.net_input_size[0],
                                     width=cfg.net_input_size[1])
    gen = torch.Generator().manual_seed(0)
    dnet = depth_network.init_network(
        gen, depth_network.DepthNetConfig(basis_inner=((128, 128, cfg.code_size),)))
    fnet = feature_network.init_network(gen, feature_network.FeatureNetConfig())
    system = SlamSystem(cfg, scene.camera, scene.mask_out, dnet, fnet, voc=voc,
                        video_mask_in=scene.mask_in, device=device)
    return system, scene, cfg


@contextlib.contextmanager
def layer_timers(system, times: dict):
    """Time the layers of process_frame (host clock, synchronised) into
    ``times[layer]`` lists while the block runs; restores the methods."""
    from .tracker import tracker

    depth = [0]

    def timed(name, fn):
        def wrapper(*args, **kwargs):
            depth[0] += 1
            outer = depth[0] == 1  # a layer called inside another is timed once
            if outer:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                depth[0] -= 1
                if outer:
                    torch.cuda.synchronize()
                    times[name].append((time.perf_counter() - t0) * 1e3)
        return wrapper

    saved = (system.mapper.build_frame, system._match_geo, system._create_keyframe, tracker.lm_track)
    system.mapper.build_frame = timed("build_frame", saved[0])
    system._match_geo = timed("match_geo", saved[1])
    system._create_keyframe = timed("create_keyframe", saved[2])
    tracker.lm_track = timed("lm_track", saved[3])
    try:
        yield
    finally:
        del system.mapper.build_frame, system._match_geo, system._create_keyframe
        tracker.lm_track = saved[3]


def drive(system, images, timestamps, frame_hook=None):
    """bootstrap on frame 0, process_frame on each later frame with a
    mapping_step after each new keyframe (every KEYFRAME_EVERY-th frame is
    made one) -> one record per processed frame:
    its result, the tracker's iterations, host and CUDA-event ms of
    process_frame, its layers' host ms, and the mapping_step's host ms,
    events ms and LM iterations (keyframe frames). ``frame_hook(f)`` runs
    before frame f, outside every timed region; a frame it returns is
    processed in place of building one from the image (the record is then
    marked ``prebuilt``)."""
    system.bootstrap(timestamps[0], images[0])
    records = []
    for f in range(1, len(timestamps)):
        prebuilt = frame_hook(f) if frame_hook is not None else None
        forced = f % KEYFRAME_EVERY == 0
        system.force_keyframe = system.force_keyframe or forced
        times = {name: [] for name in LAYERS}
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with layer_timers(system, times):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            if prebuilt is None:
                res = system.process_frame(timestamps[f], images[f])
            else:
                res = system.process_frame(timestamps[f], frame=prebuilt)
            stop.record()
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3
        layers = {name: sum(v) for name, v in times.items() if name != "rest"}
        layers["rest"] = host_ms - sum(layers.values())
        rec = dict(frame=f, result=res, iters=system.last_track_iters, ref=system.last_track_ref,
                   host_ms=host_ms,
                   event_ms=start.elapsed_time(stop), layers=layers, prebuilt=prebuilt is not None,
                   forced=forced)
        if res.new_keyframe:
            start.record()
            t0 = time.perf_counter()
            rec["map_err"] = system.mapper.mapping_step()  # ends in a host read
            stop.record()
            torch.cuda.synchronize()
            rec.update(map_ms=(time.perf_counter() - t0) * 1e3, map_event_ms=start.elapsed_time(stop),
                       map_iters=system.mapper.last_step_iters)
        records.append(rec)
    return records


def summary_lines(records, card: str):
    """Printable lines: the first tracked frame (it pays the one-time set-up
    of cuSOLVER's SVD), ms per later tracked frame (non-keyframe and
    keyframe frames apart; prebuilt frames left out), the layer split, LM
    iterations, keyframes, lost frames and ms per mapping_step."""
    first = records[0]
    out = [f"time [{card}] first tracked frame: {first['host_ms']:.3f} ms host clock, of it "
           + ", ".join(f"{name} {first['layers'][name]:.3f}" for name in LAYERS)]
    for label, keep in (("non-keyframe", False), ("keyframe", True)):
        rs = [r for r in records[1:] if r["result"].new_keyframe == keep and not r["prebuilt"]]
        if not rs:
            out.append(f"{label} frames: none")
            continue
        mean = lambda key: float(np.mean([r[key] for r in rs]))  # noqa: E731
        split = ", ".join(f"{name} {np.mean([r['layers'][name] for r in rs]):.3f}" for name in LAYERS)
        out.append(f"time [{card}] {label} frames 2-{len(records)} ({len(rs)}): {mean('host_ms'):.3f} "
                   f"ms host clock (runs {min(r['host_ms'] for r in rs):.3f}-"
                   f"{max(r['host_ms'] for r in rs):.3f}), "
                   f"{mean('event_ms'):.3f} ms CUDA events per process_frame; layers, host ms: {split}; "
                   f"LM iterations {[r['iters'] for r in rs]}")
    maps = [r for r in records if "map_ms" in r]
    n_kf = sum(r["result"].new_keyframe for r in records)
    n_forced = sum(r["result"].new_keyframe and r["forced"] for r in records)
    n_lost = sum(r["result"].tracking_lost for r in records)
    out.append(f"keyframes created {n_kf} of {len(records)} frames ({n_kf - n_forced} by the "
               f"ratios, {n_forced} forced), frames lost {n_lost}")
    if maps:
        out.append(f"time [{card}] mapping_step after a new keyframe: "
                   f"{np.mean([r['map_ms'] for r in maps]):.3f} ms host clock, "
                   f"{np.mean([r['map_event_ms'] for r in maps]):.3f} ms CUDA events, mean of {len(maps)}; "
                   f"LM iterations {[r['map_iters'] for r in maps]}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=24, help="frames of slam_scene")
    ap.add_argument("--trace", default=None, help="directory for the Chrome trace")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_slam needs a CUDA device")
    from .profile_mapper import _profile

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"card: {card}", flush=True)
    system, scene, _ = build_system(args.frames)
    dev = system.device
    images = torch.from_numpy(scene.images).to(dev)
    timestamps = [0.1 * f for f in range(args.frames)]
    records = drive(system, images, timestamps)
    for r in records:
        res = r["result"]
        print(f"frame {r['frame']:2d}: keyframe {res.new_keyframe} (forced {r['forced']}), lost "
              f"{res.tracking_lost}, area {res.area_ratio:.4f} inlier {res.inlier_ratio:.4f} motion "
              f"{res.average_motion:.5f} desc {res.desc_inlier_ratio:.4f}, "
              f"{r['iters']} LM iterations, {r['host_ms']:.3f} ms host, {r['event_ms']:.3f} ms events; "
              + ", ".join(f"{k} {v:.3f}" for k, v in r["layers"].items())
              + (f"; mapping_step {r['map_ms']:.3f} ms, {r['map_iters']} iterations" if "map_ms" in r else ""),
              flush=True)
    for line in summary_lines(records, card):
        print(line, flush=True)
    # one more frame (the last image again, a new timestamp) on copies of
    # the final state: a warm-up, then the traced call
    ts = 0.1 * args.frames
    fr = system.mapper.build_frame(ts, images[-1])
    warm = system.clone(dev).process_frame(ts, frame=dataclasses.replace(fr))
    twin = system.clone(dev)
    print(f"traced frame: keyframe {warm.new_keyframe}", flush=True)
    _profile("process_frame (frame prebuilt)", lambda: twin.process_frame(ts, frame=fr), card,
             args.trace, warmup=False)


if __name__ == "__main__":
    main()
