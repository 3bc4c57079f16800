"""Driver "full_graph_lm": full-graph LM steps over a finished map, the
problem the demo's final RefineMapping solves.

Set-up renders the map's video (``traffic/plane``), draws the weights and
the starting poses (the video's poses, the first held at the origin, the
others perturbed by noise from the seed), and builds the map through the
program's mapper: ``init_one_frame`` on the first image, then
``build_frame`` and ``enqueue_keyframe`` with back-connections to the
``connections`` keyframes before each (photometric and geometric factors
both ways). It takes the problem ``Mapper.mapping_step(full=True)`` solves
(the compact problem of every live edge, every keyframe free) and warms
up with one step. The window runs ``ba.run_ba`` from set-up's variables,
step after step, each the configuration's ``max_gn_iters`` LM iterations
(the windowed step's LM: no early exit, where ``mapping_step(full=True)``
would stop once converged), so every step does the same work; it closes
when the first step that ends past ``seconds`` returns. No step writes back
into the map, so no edge retires.

Configuration keys: ``map_keyframes``. Traffic keys: ``video`` (height,
width, radius of traffic/plane.render), ``connections``, ``pose_noise``
(rotation in radians and translation, standard deviations) and
``trace_steps`` (steps profiled after the window in a traced run).
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from benchmark import harness, peaks, system, trace
from benchmark.reference import lm, refine
from benchmark.reference.frames import Frames
from benchmark.traffic import plane


def rodrigues(v: np.ndarray) -> np.ndarray:
    """Rotation matrices [n, 3, 3] of rotation vectors [n, 3]."""
    theta = np.linalg.norm(v, axis=-1, keepdims=True)
    k = v / np.maximum(theta, 1e-12)
    kx = np.zeros(v.shape[:-1] + (3, 3))
    kx[..., 0, 1], kx[..., 0, 2] = -k[..., 2], k[..., 1]
    kx[..., 1, 0], kx[..., 1, 2] = k[..., 2], -k[..., 0]
    kx[..., 2, 0], kx[..., 2, 1] = -k[..., 1], k[..., 0]
    t = theta[..., None]
    return np.eye(3) + np.sin(t) * kx + (1 - np.cos(t)) * kx @ kx


def start_poses(trans: np.ndarray, noise: dict, seed: int):
    """The video's poses with the first at the origin and the rest
    perturbed -> (rot [K, 3, 3], trans [K, 3]) float32."""
    k = trans.shape[0]
    rng = np.random.default_rng(int(seed))
    rv = rng.normal(0.0, noise["rotation"], size=(k, 3))
    dt = rng.normal(0.0, noise["translation"], size=(k, 3))
    rv[0] = dt[0] = 0.0
    rot = rodrigues(rv).astype(np.float32)
    t = (trans - trans[0] + dt).astype(np.float32)
    return rot, t


def run(cell, seed: int, seconds: float, traced: bool, dev, t_start: float) -> dict:
    from sage_slam_tpu_torch.config import SlamConfig
    from sage_slam_tpu_torch.geometry.camera import CameraPyramid, PinholeCamera
    from sage_slam_tpu_torch.geometry.se3 import SE3
    from sage_slam_tpu_torch.mapping.mapper import Mapper
    from sage_slam_tpu_torch.solver import ba

    traffic = cell.traffic
    phases, tick = {}, time.perf_counter()
    k = int(cell.config["map_keyframes"])
    v = traffic["video"]
    scene = plane.render(k, seed, int(v["height"]), int(v["width"]), float(v["radius"]), dev)
    rot_np, trans_np = start_poses(scene.trans, traffic["pose_noise"], seed)
    rot = torch.as_tensor(rot_np, device=dev)
    trans = torch.as_tensor(trans_np, device=dev)
    cfg = SlamConfig.from_json(str(cell.config_path))
    depth_net, feat_net, state = system.networks(cell.config, seed, dev)
    ho, wo = scene.mask_out.shape
    fx, fy, cx, cy = scene.intrinsics
    cam_pyr = CameraPyramid.build(PinholeCamera(fx=fx, fy=fy, cx=cx, cy=cy, width=wo, height=ho),
                                  cfg.pyramid_levels)
    mapper = Mapper(cfg, cam_pyr, scene.mask_out, depth_net, feat_net,
                    video_mask_in=scene.mask_in, device=dev)
    system.sync(dev)
    phases["render_and_system"], tick = time.perf_counter() - tick, time.perf_counter()
    mapper.init_one_frame(0.0, scene.images[0])
    for i in range(1, k):
        fr = mapper.build_frame(float(i), scene.images[i], pose=SE3(rot[i], trans[i]))
        mapper.enqueue_keyframe(fr, refine.back_connections(i, int(traffic["connections"])))
    with mapper.store.lock:
        snap_n, _, snap_vars = mapper.store.snapshot()
        problem, start, update_mask, _, _ = mapper._compact_step_inputs(snap_n, snap_vars, True)
    mcfg = cfg.mapper
    problem = ba.prepare_problem(problem, cam_pyr)
    factors = int(problem.photo_edges.valid.sum()) + int(problem.geo_edges.valid.sum())
    phases["map"], tick = time.perf_counter() - tick, time.perf_counter()

    def step():
        vs, err, iters, _ = ba.run_ba(start, problem, cam_pyr, mcfg, update_mask,
                                      mcfg.max_gn_iters)
        return vs, float(err), iters

    step()
    system.sync(dev)
    phases["warm_up"] = time.perf_counter() - tick
    results = []
    setup_s = harness.now() - t_start
    t0 = time.perf_counter()
    while True:
        results.append(step())
        t = time.perf_counter()
        if t - t0 >= seconds:
            break
    window_s = t - t0
    iters = sum(r[2] for r in results)
    e_photo = problem.photo_edges.i0.shape[0]
    w = problem.window
    c = w.feat_pyr.shape[0]
    n_pts = w.loc1d.shape[1]
    cs = start.code_size
    out = {
        "setup_s": setup_s,
        "setup_phases": phases,
        "e2e": {"global_ba_factors_per_s": factors * iters / window_s},
        "attempted": len(results),
        "failed": sum(not math.isfinite(r[1]) for r in results),
        "window_s": window_s,
        "window_work": {"steps": len(results), "lm_iters_per_step": sorted({r[2] for r in results})},
        "ctx": {"lm_iters": iters, "window_s": window_s,
                "shapes": dict(e_photo=e_photo, e_geo=problem.geo_edges.i0.shape[0],
                               levels=cam_pyr.levels, c=c, n=n_pts, dim=13 + cs, cs=cs,
                               num_kf=start.num_kf)},
    }
    if dev.type == "cuda":
        out["ctx"]["peaks"] = peaks.peaks_for(torch.cuda.get_device_name(dev))
    if traced:
        traced_iters = []

        def steps():
            for _ in range(traffic["trace_steps"]):
                with torch.profiler.record_function(trace.STEP):
                    traced_iters.append(step()[2])

        out["traced"] = trace.profile(steps, sync=lambda: system.sync(dev))
        if len(out["traced"].kernels("photo_reduce_split")) != sum(traced_iters):
            out["trace_retried"] = (f"{len(out['traced'].kernels('photo_reduce_split'))} K1 launches "
                                    f"traced for {sum(traced_iters)} LM iterations")
            traced_iters.clear()
            out["traced"] = trace.profile(steps, sync=lambda: system.sync(dev))
        out["ctx"]["traced"] = out["traced"]
        out["ctx"]["traced_iters"] = sum(traced_iters)
    if dev.type == "cuda":
        out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev)

    # the compact problem's first k rows are the map's keyframes in order;
    # rows past them pad it to a multiple of 8 and are frozen
    got = [lm.State(r.pose.rot[:k], r.pose.trans[:k], r.code[:k], r.scale[:k])
           for r, _, _ in results]
    del mapper, problem, depth_net, feat_net
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    tick = time.perf_counter()
    frames = Frames(cell.config, scene.intrinsics, scene.mask_out, scene.mask_in, state, dev)
    ref = refine.outputs(frames, scene.images, rot, trans, int(traffic["connections"]), tf32=False)
    out["checks"] = refine.gaps(got, ref)
    out["check_s"] = time.perf_counter() - tick
    out["reference"] = (frames, scene.images, rot, trans, int(traffic["connections"]), ref)
    return out


def control(out) -> list:
    """The control's numbers for one run: the reference recomputed with TF32
    on in matmuls and cuDNN convolutions (the precision below the
    configuration's float32), against the reference in float32."""
    frames, images, rot, trans, conn, ref = out["reference"]
    low = refine.outputs(frames, images, rot, trans, conn, tf32=True)
    return refine.gaps([low["result"]], ref)
