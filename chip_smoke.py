#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (sage_slam_tpu_torch) on one GPU.

    python3 chip_smoke.py [--old-source PATH]

Phases, each of which exits non-zero on failure:

1. device: require CUDA, print the card's name and power limit, switch
   TF32 off and check it;
2. build: compile every CUDA source of the port with nvcc;
3. kernels vs plain: each kernel's wrapper on the card against its plain
   PyTorch version on the same inputs, at the shapes the window-BA path
   gives it and at the edges of the kernel's design (N % 4 != 0, N under
   one tile, one edge, dim 17, and dim 45 and 30 for the 48-wide
   instantiation), binary and soft gates; two launches on the
   same inputs must be bit-identical;
4. main path: the window-BA step (run_ba, 10 LM iterations) at the bench
   point (K=8, 64x80, CS=FS=16, L=4, N=3072, 24+24 ring edges); each
   kernel's launch count is read around that run alone; the result is
   checked for finiteness and descent, one linearize on the card is held
   against one on the CPU, and a small problem's run_ba against its CPU run;
5. times: each kernel's device time at the bench shape (torch.profiler
   kernel durations over 50 wrapper calls; CUDA events around the same 50
   calls beside it, which also count the host's enqueue), the plain
   version's and the library call's, the kernel's bound, and ms per
   10-iteration run_ba step (CUDA events and host clock after warm-up),
   after the L2 flush's check (flush_probe).
   With ``--old-source PATH`` (an earlier photo_reduce.cu with the
   two-stage C interface: tiles, partial sums) that kernel is built too and
   timed in turns with the current one (old, new, new, old);
6. mapper path: the mapping half of the system at the published widths
   (SlamConfig(): 128x160 input, 64x80 output, CS=FS=16, L=4, N=3072,
   window 8, 10 LM iterations, a 256-keyframe store; DepthNetConfig() and
   FeatureNetConfig() randomly initialised from a seeded torch.Generator)
   on synthetic.mapper_scene's 16 frames with a circular mask:
   init_one_frame, then 15 keyframes, each with back connections to the
   previous 3 and one mapping_step after it (steps 9-16 are steady-state
   windowed steps). The kernel's launch count is read around this path
   alone and must equal the LM iterations of its steps; every step must
   leave the store finite and end at or below its first linearization's
   error; TF32 must be off after the networks ran; build_frame and the last
   mapping_step are held against the same calls on the CPU from the same
   state; the kernel is held against its plain version at this path's
   steady-state shape and timed there beside the plain version and the
   library call. Prints build_frame and steady-state mapping_step
   times, the photometric edge count E the kernel saw per step and the
   store's bytes;
7. slam path: the SLAM frontend at the same widths (SlamConfig()
   defaults: tracker 40 LM iterations coarse-to-fine, 256 keypoints,
   reprojection terms, soft gate; window 8; the same random networks) on
   synthetic.slam_scene's 24 frames: bootstrap on frame 0, process_frame on
   each later frame with a mapping_step after each new keyframe (every 4th
   frame is made a keyframe through SlamSystem.force_keyframe, the others
   follow their ratios), then
   refine_mapping(2) and finalized_trajectory (profile_slam.drive). Prints
   each frame's decision, LM iterations and ratios, ms per tracked frame
   on the host clock and from CUDA events (non-keyframe and keyframe
   frames apart) with its layer split, ms per mapping_step, the keyframe
   and lost-frame counts and the peak device memory. Fails unless K1's
   launches over this path equal the LM iterations of its mapping_step and
   refine_mapping calls, every pose, depth map and variable is finite, and
   frame 13's process_frame on the card agrees with the same call on a CPU
   clone of the system from the same state (SlamSystem.clone("cpu"), the
   same prebuilt frame): equal LM iterations and keyframe decision, pose
   and ratios within 1e-4. K1 is held against its plain version and timed
   at this path's window shape;
8. loop path: loop closure at the same widths (SlamConfig() with
   LoopConfig(), the fields in LOOP_RELAXED relaxed; the same random
   networks; the repo's vocabulary eval_artifacts/bow_voc.npz) on
   synthetic.loop_scene's 43 frames out and back: bootstrap, process_frame
   per frame (every 4th frame made a keyframe), and after each new keyframe
   a mapping_step, a local and a global loop tick, and one more mapping_step
   when a tick added a loop link; then refine_mapping(2). Fails unless a
   global loop closes, the mapping_step after a loop link holds the link's
   photometric edges, K1's launches equal the mapping LM iterations, every
   pose, depth map and variable is finite. After the path (its clock
   stopped for the clones), the first close_global_loops and the one at
   the revisit are held against the same call on a CPU clone of the state
   before it (equal pose-graph iterations, reinitialize counts and links;
   poses 1e-4, scales 1e-4 relative), once as configured and once with
   Gaussian loop edges (pose_graph_dcs_factor=0) on a card and a CPU
   clone, which must move some pose or scale by over 1e-3 so that the
   hold can fail; LoopConfig()'s own gates are probed on a clone where its
   window admits a candidate. Prints the gate rejections
   (SlamSystem.loop_rejections), per keyframe the loop detections with
   their ms and 7-DoF tracks, host and CUDA-event ms per call of the loop
   methods (their utils/timing spans), the peak device memory and K1 at
   the loop window. Then SlamDriver(system, use_native_threads=True).run on
   a fresh system over the same scene: every keyframe searched by both
   loop backends, finite state, K1 launched by the mapping worker, and a
   worker's exception fails the phase; prints frames per second and
   timing.report(), which gives each thread's solver set-up apart;
9. demo path: the port's demo CLI, threaded as a user runs it
   (demo/run_slam.run, the body of main, which also returns the system),
   over the first 32 frames of eval_artifacts/EVAL.md's 64-frame Bowl3D
   orbit (DEMO_URL: 31/63 of the orbit, at its per-frame motion; phase 11
   runs the whole orbit with trained networks) at
   eval_artifacts/slam_config.json's widths (128x160 -> 64x80, CS=FS=16,
   L=4, N=3072, window 8, LoopConfig's own gates, a 32-keyframe store) with
   the networks of net_netcfg.json randomly initialised and the repo's
   vocabulary, writing into _runs/demo (DEMO_KEYFRAME_RELAXED names
   any relaxed keyframe gate). Fails unless the summary reports 64 frames
   and at least 2 keyframes, K1's launches equal the LM iterations of the
   run's mapping_step and refine_mapping calls (Mapper.step_iters_total),
   every pose, depth map and variable is finite, the three TUM files read
   back through read_tum equal the system's trajectories to the printed
   precision and one depth .npy per keyframe is written. Prints frames/s,
   the timing report, ms per process_frame, keyframes, loops and gate
   rejections, the frame generation's ms per frame apart, peak device
   memory, whether map.png was written, and frame and keyframe Sim3/SE3-ATE
   and keyframe depth RMSE against Bowl3D's ground truth (no bound: random
   weights). Then K1 at the demo's final window against its plain version,
   timed; save_state and load_state into a fresh card system: every row
   and derived table bit-equal and the next mapping_step equal on both
   (iterations, error within 1e-5 relative); and the ground-truth hold
   that can fail: tests/test_ate_regression.py's perfect-prior run in the
   port on the card, on that test's inputs (its JAX sample draws,
   synthetic.PERFECT_PRIOR_DRAWS), held to its bounds (frame Sim3-ATE under
   5.5% of the span, keyframe under 5.0%, depth RMSE under 0.05), with the
   port's own draws printed beside it;
10. train path: the training slice at demo/make_eval.py's widths
   (128x160 -> 64x80, CS=FS=16, DepthNetConfig(basis_inner=((128, 128,
   16),)), FeatureNetConfig(), DiscConfig(64, 80), TrainConfig(
   pyramid_levels=4, ba_iters=2, num_photo_samples=128, eval_fraction=0.2,
   cycle_steps=200)). First K1's gradient: photo_reduce on tensors that
   carry a graph (K1 forward, the closed-form backward of
   ops/photo_reduce.PhotoReduceFn) against autograd through
   photo_reduce_ref, every input's and the weights' cotangent, at the
   training shape (E=1, N=128) and the bench shape (E=24, N=3072), binary
   and soft gates, within 1e-4 of each cotangent's max |value|, with the
   backward timed; K1 at the training shape against its plain version,
   timed beside the plain version, the library call and its bound. Then 6
   triplets on make_eval's first training orbit (TRAIN_BOWL, the port's
   ArraySequenceDataset; cv2 decides the branch, and the line says which) and
   train.train over 2 epochs (epoch 0 separate, epoch 1 joint; 5 training
   triplets, 1 held out) into the git-ignored _runs/train. Fails unless K1's
   forward launches equal 8 x (5 joint train steps + 1 joint eval step) =
   48, its backward ran 2 x 5 times, the history's phases are [False, True]
   with a flow entry in the joint eval, every logged value and parameter is
   finite and the BA weights and log sigma changed; one joint train step on
   the card is held against the same step on a CPU copy, and each
   generator leaf's gradient against the CPU's and against a second pass
   on the card (TRAIN_HOLD_*), the BA's LM decisions equal in all three
   passes; the
   exported networks, loaded as the demo loads them, build the same frame
   bit for bit; a resume restores epoch 2 and every parameter. Prints ms
   per separate, joint and eval step (host clock and CUDA events) and the
   peak device memory;
11. eval path: dense and diagnostic eval. (b) demo/make_eval.run, the
   body of the port's make_eval CLI, at its operating point (128x160 ->
   64x80, CS=FS=16, N=3072, L=4) with --separate_only, cut in depth only
   (MAKE_EVAL_CUTS: 4 epochs, 16 triplets, a 90 s training budget), into
   the git-ignored _runs/make_eval: train, export, vocabulary, the threaded
   demo over the 64-frame eval orbit, ATE and depth RMSE, TSDF fusion and
   mesh, fly-through, report.json and EVAL.md. Fails unless K1's launches
   over the chain equal the demo's mapping LM iterations, every artifact
   is written and well formed (the TUM files read back, one depth file per
   keyframe, reconstruction.ply parses with faces indexing its vertices,
   report.json equals the returned report, EVAL.md names the card), and the
   exported networks load through the demo's loaders equal to the run's.
   K1 is held against its plain version and timed at the demo's final
   window. (a) the chain's 96^3 TSDF volume integrated on the card and on
   CPU tensors from the same keyframes: tsdf and weight within 1e-5 on the
   voxels away from a rounding boundary (tsdf.near_rounding_boundary), the
   flipped voxels counted and held to TSDF_FLIP_SHARE; prints the device ms
   per integrate (CUDA events) and the volume's bytes; fly_through gives 8
   lit uint8 frames. (c) eval/error_budget.run's A and C rows over the
   64-frame orbit of docs/error_budget_r05.json, printed beside that TPU
   run's rows; finite values, keyframes within 3 of its count, and K1's
   launches equal the stages' mapping LM iterations. (d) eval/gt_probe at
   docs/gt_probe_r05_64x80.json's configuration (GT_PROBE: 128x160, 64
   frames, stride 4, 16 keyframes at exact ground truth): grad_report on
   the card against the same call on SlamSystem.clone("cpu") within
   GT_PROBE_GRAD_RTOL per term and variable class, section_report at
   GT_PROBE_SECTION_STEPS steps, walk_report's 12 rounds printed beside the
   TPU run's keyframe ATE; K1's launches equal grad_report's
   linearizations plus the walk's LM iterations; K1 held and timed at the
   full graph;
12. the default-off paths and multi-device BA. (a) run_ba with
   solver="schur" against "dense" at the bench
   point (error rtol 1e-5; translations and codes rtol 1e-4 + atol 1e-6),
   and solver="auto" on synthetic.bench_problem(k=48, 96+96 ring edges),
   which must take the Schur branch (ATOL_48 on translations and codes);
   ms per step of each solver. (b) Mapper.mapping_step(mesh=) on a
   one-rank NCCL group (parallel/launch.one_rank) on clones of phase 6's
   mapper (the 256-keyframe store: a 5888-wide system) against the
   unsharded mapping_step from the same state (error rtol 1e-4; poses,
   codes and scales atol 1e-5; the same iterations and edge budgets),
   windowed and with refine_mapping's coarse photo_weights (full=True),
   which the JAX package refuses; K1's launches equal the step's LM
   iterations; ms per sharded and unsharded step. (c) two gloo ranks on
   the one card (parallel/launch.spawn): sharded_run_ba and
   sharded_window_run_ba at the bench point, each rank 12 of the 24 edges
   per family and half the keyframe rows, against one process's run_ba /
   compact run_ba (tests/test_sharded_ba.py's and
   tests/test_sharded_store.py's tolerances), the two ranks' variables
   bit-equal, each rank's K1 launches equal to the LM iterations; prints
   each rank's store-table bytes beside store_bytes_per_device.
   K1 is held
   and timed at phase 6's window under the mesh path and at one rank's
   E=12. Prints the phase's time;
13. the measuring programs: each program's main run in this process on
   the card at its JAX program's operating point, its output echoed:
   entry (entry()'s step and dryrun_multichip(1), whose two dryruns with
   no devices named must run on cuda:0 in an NCCL group), bench.global_ba,
   bench.roofline, bench.frontend (64 frames), bench.scaling on one NCCL
   rank with growth_curve up to 128 keyframes, and on two gloo ranks on
   the one card without it. Fails unless each program's first line names
   the card, its lines carry its JAX program's metric names (PROGRAM_METRICS,
   ROOFLINE_KEYS) with finite values, and K1's launches equal the LM
   iterations that the program's steps ran, warm-up included (the
   frontend runs no BA step, so none); K1's launches are read around each
   program, the spawned ranks' from what they return. K1 is held and timed
   at the shapes these programs give it beyond the bench point: scaling's
   rank problem (E=64 on one rank, E=32 a rank on two, N=1024) and
   growth_curve's 128-keyframe full step (E=284, N=1024), and the L2
   flush's check (flush_probe) is made again, before the scaling runs;
14. the prep kernel (ops/photo_prep, csrc/photo_prep.cu): its five
   outputs against the plain chain's (photometric.photo_prep) on the same
   inputs, element by element, and K1 on each, at the bench point (E=24),
   a mapper window (E=48), growth_curve's full step (E=284, N=1024) and
   the benchmark cell's problem (cell_problem: 64 keyframes through the
   mapper, E=372), each with drawn codes and scales, with and without the
   prepared decode tables, and with points behind the camera, outside
   every image and at NaN coordinates (prep_variants), both gates; the
   tolerances and their reasons are PREP_*'s. Fails unless the source
   features are bit-equal, every other output is within its tolerance
   (a gate may differ only at a point next to a step of the gate) and
   run_ba on the cell's problem makes one prep launch, one
   photo.prep_kernel count and one K1 launch an LM iteration. Times the
   kernel (cold L2, warm beside) against its bound (prep_bound) and the
   plain chain, at the bench point and the cell's shape. The same again
   at CS = 32 (the 32-code prep and the 48-wide K1: the bench point, a
   mapper window and the cell's problem at CS = 32, E=24, 48 and 372),
   where run_ba's lin.photo spans must count photo.k1_pad 48 and
   photo.prep_cs 32 (32 and 16 at CS = 16); K1 is held to its plain
   version and timed (cold and warm, against reduce_bound) on the cell's
   prep at both widths;
15. the Hessian assembly kernel (solver/graph.scatter_hessian on the
   card, csrc/hessian_assembly.cu): the five calls of one ba.linearize on
   both cells' problems (cell_problem at CS = 16 and 32, phase 14's),
   each held against the one-hot path (graph.scatter_hessian_ref, run on
   the card) and a float64 index_add_ sum within ASSEMBLY_RTOL of max |H|;
   two calls bitwise equal, H exactly symmetric, the linearization's own
   H equal bitwise to the five calls replayed; run_ba on each cell counts
   5 assembly.kernel an LM iteration. Times each call and the five
   together (cold L2, warm beside) against a bytes bound (assembly_bound:
   the valid edges' indices, blocks and vectors read once, the touched
   tiles of H and rows of b read and written once, at the memory rate),
   and the one-hot path beside;
16. the geometric factor's linearization kernels (ba.linearize's lin.geo
   on the card: ops/geo_linearize, csrc/geo_linearize.cu, three launches a
   call) against the plain chain (build_frame1_tables + geometric_jac_error,
   run on the card) at the bench point, a mapper window and both cells'
   problems (E = 24, 48, 372 at CS = 16 and 32), each with prep_variants'
   three variants: on every edge n_inl exact, ata and atb within GEO_RTOL +
   GEO_ATOL of max |ata|, the error within GEO_RTOL (an edge with points at
   a step of the nearest-pixel mask or the z test, GEO_STEP_PX, held
   against the plain chain with some flipped where it misses it unflipped;
   the held and flipped counts printed); two calls bitwise equal,
   ata exactly symmetric; run_ba on each cell counts one geo.kernel and the
   code width an LM iteration. Times the kernels (cold L2, warm beside)
   against geo_bound (FP32 operations or bytes), the plain chain and
   torch.bmm of the Gram alone, and holds run_ba on both cells' problems,
   card against CPU, to GEO_RUN_BA_GAP. Alone, with the cells built:
   ``chip_smoke.geo_path(dev, card, (peak_bw, peak_flops))``;
17. a JSON line listing every kernel, then the card line, then the last
   line ``{"ok": true, "device": {...}}``.

K1's times (phases 5-13) are device times with a cold L2: a 96 MB scratch
buffer is read three times before each timed call (flush_l2), which
leaves the L2 holding clean lines only, the flush's kernels left out; the warm readings
(back-to-back calls on the same inputs, which the L2 partly serves) are
printed beside them. A cold reading over K1_MAX_SHARE (105%) of its bound
fails the script, and so does a plain read (93 MB or 24 MB) timed cold
that runs over 105% of the card's memory rate (flush_probe, phase 5).

Imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
WEIGHTS = (10.0, 9.0, 8.0, 7.0)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps launches (CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _kernel_times(fn, reps: int, between=None) -> dict:
    """torch.profiler's device microseconds and event counts by kernel name
    over reps calls of fn(), each preceded by between() when given ->
    {name: (us, count)}."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if between is not None:
                between()
            fn()
        torch.cuda.synchronize()
    return {e.key: (e.self_device_time_total, e.count) for e in prof.key_averages()
            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA}


# Cold-L2 timing: before each timed call a scratch buffer of FLUSH_BYTES
# (about twice the H100's 50 MB L2) is read FLUSH_PASSES times over, in one
# kernel (its int32 rows reduced by max, pass after pass, into a small
# output), so that each call reads its inputs from HBM as a caller that has
# just run other work does, and finds the L2 holding clean lines only (an
# overwrite would leave up to 50 MB of dirty lines there, written back
# during the timed call). The passes re-reference the flush's own lines, so
# that a replacement policy that resists one-pass scans still gives up the
# timed call's lines. The flush's own kernel, which no timed function runs,
# is left out of the sums by name.
FLUSH_BYTES = 96 << 20
FLUSH_PASSES = 3
FLUSH_ROW = 4096
_flush = {}


def _flush_read():
    torch.amax(_flush["passes"], dim=2, out=_flush["out"])


def flush_l2():
    """Read the scratch buffer -> the flush's kernel names (found once by
    profiling the flush alone)."""
    if "passes" not in _flush:
        rows = FLUSH_BYTES // 4 // FLUSH_ROW
        buf = torch.ones((rows, FLUSH_ROW), dtype=torch.int32, device="cuda")
        _flush["passes"] = buf.expand(FLUSH_PASSES, rows, FLUSH_ROW)  # stride 0: the same bytes again
        _flush["out"] = torch.empty((FLUSH_PASSES, rows), dtype=torch.int32, device="cuda")
        _flush["keys"] = set(_complete_profile(_flush_read, 1, None, bool, "the L2 flush"))
    _flush_read()
    return _flush["keys"]


# torch.profiler on the card has returned profiles without some or all of
# their kernels in whole-script runs, which open hundreds of profiles, and
# once it did, every later profile of the process came back empty: each
# measurement takes one profile, and an incomplete one is taken again after
# a pause, up to PROFILE_TRIES times. KINETO_CONFIG raises kineto's cap on
# CUPTI activity buffers, in case that cap is what stops it.
PROFILE_TRIES = 3
KINETO_CONF = "ACTIVITIES_MAX_GPU_BUFFER_SIZE_MB=1024\n"


def _complete_profile(fn, reps: int, between, complete, what: str) -> dict:
    """_kernel_times(fn, reps, between), taken again until complete(its
    result) holds; fails after PROFILE_TRIES profiles."""
    for attempt in range(PROFILE_TRIES):
        if attempt:
            time.sleep(attempt)
        times = _kernel_times(fn, reps, between)
        if complete(times):
            return times
        say(f"device_ms: profile {attempt + 1} of {what} is incomplete ({len(times)} kernel names "
            "recorded); profiling again")
    fail(f"torch.profiler recorded no complete profile of {what} in {PROFILE_TRIES} tries")


def device_ms(fn, reps: int, match: str | None = None, cold: bool = False) -> float:
    """Device time of one fn() call: the durations of its kernels (those
    whose name holds ``match``, else all) from one torch.profiler profile
    of reps calls, each kernel's mean duration times its calls per fn()
    call. ``cold`` flushes the L2 before each call (flush_l2) and leaves
    the flush's kernel out; it fails if fn itself runs a kernel of the
    flush's name (more flush events than flushes). A profile without a
    kernel of fn or, cold, without the flush is taken again
    (PROFILE_TRIES). The profiler drops events now and then: each kernel's
    calls per fn() call are its events over the calls recorded (the
    flushes' events when cold, else reps), and a profile short of events is
    said so. Fails if no complete profile came."""
    what = match or "the plain version"
    fn()  # warm-up
    skip = flush_l2() if cold else set()

    def complete(t):
        return skip <= set(t) and any(k not in skip and (match is None or match in k) for k in t)

    times = _complete_profile(fn, reps, flush_l2 if cold else None, complete, what)
    for key in skip:
        if times[key][1] > reps:
            fail(f"the timed function runs the L2 flush's kernel {key[:80]} "
                 f"({times[key][1]} events for {reps} flushes)")
    # the calls whose events the profile holds: one flush each when cold
    calls = min(times[key][1] for key in skip) if cold else reps
    timed = {k: v for k, v in times.items() if k not in skip and (match is None or match in k)}
    total_us, short = 0.0, 0
    for key, (us, count) in timed.items():
        per_call = max(1, round(count / calls))
        short += count != per_call * reps
        total_us += us / count * per_call
    if short:
        say(f"device_ms: the profile of {what} lacks events of {short} of {len(timed)} kernel names "
            f"(flushes recorded: {calls if cold else 'none'} of {reps}); each kernel's mean is used")
    if total_us <= 0:
        fail(f"torch.profiler recorded no device time for {what}")
    return total_us / 1e3


# a K1 reading over this share of its bound is refused: no card beats its
# own memory rate, so the timing or the bound's byte count is wrong
K1_MAX_SHARE = 1.05


def k1_times(run_kernel, run_plain, run_library, bound_ms: float, label: str, reps: int = 50) -> dict:
    """K1, its plain version and the library call timed cold (flush_l2
    between calls) and warm (back-to-back calls on the same inputs) ->
    {ms, plain_ms, library_ms, warm_ms, warm_plain_ms, warm_library_ms}.
    Fails if K1's cold reading is over K1_MAX_SHARE of its bound. Launches
    made here are not counted."""
    from sage_slam_tpu_torch.ops import photo_reduce as pr

    saved = pr.photo_reduce.launches
    for fn in (run_kernel, run_plain, run_library):
        fn()
    out = dict(
        ms=device_ms(run_kernel, reps, "photo_reduce", cold=True),
        plain_ms=device_ms(run_plain, reps, cold=True),
        library_ms=device_ms(run_library, reps, cold=True),
        warm_ms=device_ms(run_kernel, reps, "photo_reduce"),
        warm_plain_ms=device_ms(run_plain, reps),
        warm_library_ms=device_ms(run_library, reps),
    )
    pr.photo_reduce.launches = saved
    if bound_ms / out["ms"] > K1_MAX_SHARE:
        fail(f"K1 at {label}: cold reading {out['ms']:.6f} ms is {bound_ms / out['ms']:.1%} of its "
             f"bound {bound_ms:.6f} ms (over {K1_MAX_SHARE:.0%})")
    return out


# the flush's check: plain reads (float32 rows summed) timed as K1 is, of
# the bench point's input bytes (93 MB: a stream over the L2's size, which
# the L2 cannot serve warm either, so cold and warm should agree unless the
# flush leaves work behind) and of 24 MB (which the L2 holds warm)
PROBE_ROW = 1024
PROBE_ROWS = (22_750, 5_860)


def flush_probe(peak_bw: float, card: str) -> list:
    """Each PROBE_ROWS read timed cold (flush_l2 before each call) and
    warm -> per read its bytes, ms and GB/s both ways. Fails if a cold
    rate is over K1_MAX_SHARE of the card's memory rate: the flush would
    not have emptied the L2."""
    out = []
    for rows in PROBE_ROWS:
        x = torch.ones((rows, PROBE_ROW), device="cuda")
        y = torch.empty(rows, device="cuda")
        nbytes = (x.numel() + y.numel()) * 4

        def read():
            torch.sum(x, dim=1, out=y)

        read()
        cold, warm = device_ms(read, 50, cold=True), device_ms(read, 50)
        r = dict(bytes=nbytes, cold_ms=cold, warm_ms=warm, cold_GBps=nbytes / cold / 1e6,
                 warm_GBps=nbytes / warm / 1e6)
        say(f"time [{card}] L2 flush check: a plain read of {nbytes / 1e6:.1f} MB (row sums) cold "
            f"{cold:.6f} ms = {r['cold_GBps']:.1f} GB/s ({r['cold_GBps'] * 1e9 / peak_bw:.1%} of "
            f"{peak_bw / 1e12} TB/s), warm {warm:.6f} ms = {r['warm_GBps']:.1f} GB/s")
        if r["cold_GBps"] * 1e9 > K1_MAX_SHARE * peak_bw:
            fail(f"the L2 flush does not empty the L2: a cold read ran at {r['cold_GBps']:.1f} GB/s")
        out.append(r)
    return out


def old_reduce(path: str, build_dir):
    """An earlier kernel source with the two-stage C interface (tiles, then
    partial sums, photo_reduce_num_tiles) built from path, as a function of
    the current wrapper's arguments."""
    from sage_slam_tpu_torch import _build

    out = os.path.join(build_dir, "photo_reduce_old.so")
    os.makedirs(build_dir, exist_ok=True)
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", out, path],
                   check=True, capture_output=True, timeout=600)
    lib = ctypes.CDLL(out)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.photo_reduce_launch.argtypes = [ptr] * 10 + [i32] * 5 + [
        ctypes.POINTER(ctypes.c_float), ptr]
    lib.photo_reduce_num_tiles.argtypes = [i32]

    def run(fgs, f0, gate, kx, ky, weights, ratios):
        e, lv, c3, n = fgs.shape
        dim = kx.shape[1]
        n_out = dim * (dim + 1) // 2 + dim + 2
        dev = fgs.device
        partial = torch.empty((e, lib.photo_reduce_num_tiles(n), n_out), device=dev)
        ata = torch.empty((e, dim, dim), device=dev)
        atb = torch.empty((e, dim), device=dev)
        err = torch.empty((e,), device=dev)
        n_inl = torch.empty((e,), device=dev)
        host = (ctypes.c_float * (3 * lv))(*[float(w) for w in weights[:lv]],
                                           *[float(r[0]) for r in ratios],
                                           *[float(r[1]) for r in ratios])
        status = lib.photo_reduce_launch(
            fgs.data_ptr(), f0.data_ptr(), gate.data_ptr(), kx.data_ptr(), ky.data_ptr(),
            partial.data_ptr(), ata.data_ptr(), atb.data_ptr(), err.data_ptr(),
            n_inl.data_ptr(), e, lv, c3 // 3, n, dim, host,
            torch.cuda.current_stream().cuda_stream)
        if status != 0:
            fail(f"old photo_reduce kernel launch failed: CUDA error {status}")
        return ata, atb, err, n_inl

    return run


def reduce_inputs(e, lv, c, n, dim, soft, seed, dev):
    rng = np.random.default_rng(seed)
    gate = rng.random((e, n)).astype(np.float32)
    if not soft:
        gate = (gate > 0.2).astype(np.float32)
    arrays = (
        rng.standard_normal((e, lv, 3 * c, n)).astype(np.float32),
        rng.standard_normal((e, lv, c, n)).astype(np.float32),
        gate,
        rng.standard_normal((e, dim, n)).astype(np.float32),
        rng.standard_normal((e, dim, n)).astype(np.float32),
    )
    return tuple(torch.from_numpy(a).to(dev) for a in arrays)


def compare_reduce(out, ref, binary: bool, label: str):
    """test_pallas.py's tolerances: ata/atb rtol 1e-4 + atol 1e-6 max|ata|,
    err rtol 2e-5, n_inl exact for a binary gate (rtol 1e-5 for a soft one).
    Returns the largest absolute difference over the four outputs and the
    largest one relative to its output's max |value| (ata entries reach
    ~1e6 on random inputs; the tolerances above are what decide)."""
    ata, atb, err, n_inl = (x.double().cpu().numpy() for x in out)
    ata_r, atb_r, err_r, n_r = (x.double().cpu().numpy() for x in ref)
    scale = float(np.abs(ata_r).max())
    np.testing.assert_allclose(ata, ata_r, rtol=1e-4, atol=1e-6 * scale, err_msg=label)
    np.testing.assert_allclose(atb, atb_r, rtol=1e-4, atol=1e-6 * scale, err_msg=label)
    np.testing.assert_allclose(err, err_r, rtol=2e-5, err_msg=label)
    if binary:
        np.testing.assert_array_equal(n_inl, n_r, err_msg=label)
    else:
        np.testing.assert_allclose(n_inl, n_r, rtol=1e-5, err_msg=label)
    if not np.array_equal(ata, np.swapaxes(ata, -1, -2)):
        fail(f"{label}: kernel ata is not bit-symmetric")
    pairs = ((ata, ata_r), (atb, atb_r), (err, err_r), (n_inl, n_r))
    abs_err = max(float(np.abs(a - b).max()) for a, b in pairs)
    rel_err = max(float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)) for a, b in pairs)
    return abs_err, rel_err


def reduce_bound(prep, peak_bw: float, peak_flops: float):
    """The reduce's least time on the card for these inputs: the larger of
    its bytes (each input read once, each output written once) over the
    memory rate and its FP32 operations over the peak rate ->
    (bound_ms, "bytes" | "operations", in_bytes, out_bytes, flops)."""
    fgs, _, _, kx, _ = prep
    e, lv, c3, n = fgs.shape
    dim = kx.shape[1]
    in_bytes = sum(t.numel() * t.element_size() for t in prep)
    out_bytes = 4 * (e * dim * dim + e * dim + 2 * e)
    npairs = dim * (dim + 1) // 2
    flops = e * n * (lv * (c3 // 3) * 13 + npairs * 10 + dim * 4 + 2)
    t_bytes, t_ops = (in_bytes + out_bytes) / peak_bw, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations", in_bytes, out_bytes, flops


def library_call(prep):
    """The library call timed beside the reduce: torch.bmm of its final
    contraction only, kx @ kgx^T + ky @ kgy^T, on the same K-rows (gradient
    Gram weights drawn under the gate)."""
    _, _, gate, kx, ky = prep
    g2 = gate * gate
    gxx, gxy, gyy = (torch.rand_like(gate) * g2 for _ in range(3))
    kgx = gxx[:, None] * kx + gxy[:, None] * ky
    kgy = gxy[:, None] * kx + gyy[:, None] * ky
    return lambda: torch.bmm(kx, kgx.transpose(1, 2)) + torch.bmm(ky, kgy.transpose(1, 2))


def rel_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over max |b| (on the host, in float64)."""
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def reduce_at_path_shape(mapper, cfg, pyr, card: str, peaks, path: str, window_lo=None) -> dict:
    """K1 on the photometric inputs of the window of a path's final state
    (the edges incident to its keyframes from ``window_lo`` on, by default
    its last window_size keyframes), against its plain version, and timed
    there beside the plain version and the library call. Launches made here
    are not counted."""
    from sage_slam_tpu_torch.geometry.se3 import SE3
    from sage_slam_tpu_torch.ops import photo_reduce as pr
    from sage_slam_tpu_torch.ops import photometric
    from sage_slam_tpu_torch.solver import ba

    n = mapper.store.num_active
    lo = max(0, n - cfg.mapper.window_size) if window_lo is None else window_lo
    problem = ba.prepare_problem(
        ba.slice_problem_keyframes(mapper.build_problem(window_lo=lo), n, pyr), pyr)
    v = mapper.store.variables
    pe = problem.photo_edges
    kf0, fr1, shared = ba._photo_inputs(problem.window, pe)
    prep = photometric.photo_prep(
        SE3(v.pose.rot[pe.i0], v.pose.trans[pe.i0]), SE3(v.pose.rot[pe.i1], v.pose.trans[pe.i1]),
        v.code[pe.i0], v.scale[pe.i0], kf0, fr1, shared, pyr, cfg.mapper.dpt_eps,
        soft=cfg.mapper.soft_inlier_gate,
    )
    weights, ratios = tuple(cfg.mapper.photo_factor_weights), photometric.level_ratios(pyr)
    return k1_hold(prep, weights, ratios, card, peaks, f"the {path} path's window prep inputs")


def k1_hold(prep, weights, ratios, card: str, peaks, label: str, binary: bool = False) -> dict:
    """K1 on one linearization's prep inputs against its plain version, and
    timed there (cold L2, the warm reading beside) with the plain version,
    the library call and the bound. Launches made here are not counted."""
    from sage_slam_tpu_torch.ops import photo_reduce as pr

    saved = pr.photo_reduce.launches
    out = pr.photo_reduce(*prep, weights, ratios)
    ref = pr.photo_reduce_ref(*prep, weights, ratios)
    pr.photo_reduce.launches = saved
    abs_err, rel_err = compare_reduce(out, ref, binary, label)
    bound_ms, bound_by, in_b, out_b, _ = reduce_bound(prep, *peaks)
    t = k1_times(lambda: pr.photo_reduce(*prep, weights, ratios),
                 lambda: pr.photo_reduce_ref(*prep, weights, ratios), library_call(prep), bound_ms, label)
    say(f"kernel vs plain: photo_reduce on {label} "
        f"{tuple(prep[0].shape)}: ok; [{card}] cold L2: device {t['ms']:.6f} ms, plain "
        f"{t['plain_ms']:.4f} ms, library bmm of the final contraction {t['library_ms']:.4f} ms, bound "
        f"{bound_ms:.6f} ms by {bound_by} ({(in_b + out_b) / 1e6:.1f} MB) = {bound_ms / t['ms']:.1%} of "
        f"bound; warm L2 (back-to-back calls): device {t['warm_ms']:.6f} ms "
        f"({bound_ms / t['warm_ms']:.1%} of bound), plain {t['warm_plain_ms']:.4f} ms, library "
        f"{t['warm_library_ms']:.4f} ms")
    return dict(max_abs_err=abs_err, max_rel_err=rel_err,
                shape=dict(E=int(prep[0].shape[0]), bound_ms=bound_ms, bound_by=bound_by, **t))


def mapper_path(dev, card: str, peaks) -> dict:
    """Phase 6: the mapper at the published widths (see the module note).
    Returns what the kernels line and the summary need."""
    from sage_slam_tpu_torch import synthetic
    from sage_slam_tpu_torch.config import SlamConfig
    from sage_slam_tpu_torch.geometry.camera import CameraPyramid
    from sage_slam_tpu_torch.geometry.se3 import SE3
    from sage_slam_tpu_torch.mapping.mapper import Mapper
    from sage_slam_tpu_torch.models import depth_network, feature_network
    from sage_slam_tpu_torch.ops import photo_reduce as pr
    from sage_slam_tpu_torch.solver import ba

    cfg = SlamConfig()
    n_frames, steady_from = 16, 8  # keyframes 9-16 are the steady-state steps
    scene = synthetic.mapper_scene(n_frames, seed=0, height=cfg.net_input_size[0],
                                   width=cfg.net_input_size[1])
    pyr = CameraPyramid.build(scene.camera, cfg.pyramid_levels)
    gen = torch.Generator().manual_seed(0)
    dnet = depth_network.init_network(
        gen, depth_network.DepthNetConfig(basis_inner=((128, 128, cfg.code_size),)))
    fnet = feature_network.init_network(gen, feature_network.FeatureNetConfig())
    mapper = Mapper(cfg, pyr, scene.mask_out, dnet, fnet, video_mask_in=scene.mask_in, device=dev)
    images = torch.from_numpy(scene.images).to(dev)
    poses = [SE3(torch.from_numpy(scene.rot[f]).to(dev), torch.from_numpy(scene.trans[f]).to(dev))
             for f in range(n_frames)]
    say(f"mapper path: {n_frames} frames {tuple(scene.images.shape[2:])} -> "
        f"{tuple(scene.mask_out.shape)}, mask {int(scene.mask_out.sum())} valid pixels, "
        f"N={mapper.num_samples}, window {cfg.mapper.window_size}, {cfg.mapper.max_gn_iters} LM "
        f"iterations, store capacity {cfg.max_keyframes}")

    # each step's first linearization error, read after the step
    first_errors = []
    linearize = ba.linearize

    def recording_linearize(*args, **kwargs):
        out = linearize(*args, **kwargs)
        first_errors.append(out[2])
        return out

    steps = []
    cpu_mapper = None
    ba.linearize = recording_linearize
    try:
        torch.cuda.synchronize()
        pr.photo_reduce.launches = 0
        mapper.init_one_frame(0.0, images[0])
        for f in range(1, n_frames):
            fr = mapper.build_frame(0.1 * f, images[f], pose=poses[f])
            n = mapper.store.num_active
            back = list(range(n - 1, max(-1, n - 1 - cfg.keyframe.temporal_max_back_connections), -1))
            mapper.enqueue_keyframe(fr, back)
            if f == n_frames - 1:  # the state the CPU step starts from
                ba.linearize = linearize
                cpu_mapper = mapper.clone("cpu")
                ba.linearize = recording_linearize
            first_errors.clear()
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            err = mapper.mapping_step()  # ends in a host read of the error
            stop.record()
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3
            v = mapper.store.variables
            if not all(bool(torch.isfinite(t).all()) for t in (*v.pose, v.code, v.scale)):
                fail(f"mapper path: non-finite store variables after step {f + 1}")
            first = float(first_errors[0])
            if not err <= first:
                fail(f"mapper path: step {f + 1} error {err} above its first linearization's {first}")
            steps.append(dict(keyframes=f + 1, iters=mapper.last_step_iters,
                              converged=mapper.last_step_converged, edges=mapper.last_step_edges,
                              first=first, err=err, host_ms=host_ms,
                              event_ms=start.elapsed_time(stop)))
        torch.cuda.synchronize()
        launches = pr.photo_reduce.launches
    finally:
        ba.linearize = linearize
    iters_total = sum(st["iters"] for st in steps)
    for st in steps:
        say(f"  step {st['keyframes']:2d} keyframes: E photo/geo {st['edges'][0]}/{st['edges'][1]}, "
            f"{st['iters']} iterations, converged {st['converged']}, error {st['first']:.6g} -> "
            f"{st['err']:.6g}, {st['host_ms']:.3f} ms host, {st['event_ms']:.3f} ms events")
    say(f"mapper path: photo_reduce launches {launches}, LM iterations {iters_total}")
    if launches == 0 or launches != iters_total:
        fail(f"mapper path: photo_reduce launched {launches} times for {iters_total} LM iterations")
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        fail("mapper path: TF32 is allowed after the networks ran")

    # the last step on the CPU from the same state
    card_last = steps[-1]
    cpu_err = cpu_mapper.mapping_step()
    if (cpu_mapper.last_step_iters, cpu_mapper.last_step_converged) != (
            card_last["iters"], card_last["converged"]):
        fail(f"mapper step card vs CPU: iterations/converged {card_last['iters']}/"
             f"{card_last['converged']} vs {cpu_mapper.last_step_iters}/{cpu_mapper.last_step_converged}")
    n = mapper.store.num_active
    vg, vc = mapper.store.variables, cpu_mapper.store.variables
    diffs = {
        "trans": float((vg.pose.trans[:n].cpu() - vc.pose.trans[:n]).abs().max()),
        "rot": float((vg.pose.rot[:n].cpu() - vc.pose.rot[:n]).abs().max()),
        "code": float((vg.code[:n].cpu() - vc.code[:n]).abs().max()),
        "scale": float(((vg.scale[:n].cpu() - vc.scale[:n]) / vc.scale[:n]).abs().max()),
    }
    # float32 roundoff through 10 LM iterations of a 16-keyframe solve
    # (other sum orders on the card): absolute 1e-4 on poses and codes,
    # relative 1e-4 on scales; the error to rtol 1e-4
    if max(diffs.values()) > 1e-4 or abs(cpu_err - card_last["err"]) > 1e-4 * abs(cpu_err):
        fail(f"mapper step card vs CPU: {diffs}, error {card_last['err']} vs {cpu_err}")
    say(f"mapper step card vs CPU ({n} keyframes, {card_last['iters']} iterations): max |d| "
        + ", ".join(f"{k} {v:.3g}" for k, v in diffs.items())
        + f"; error {card_last['err']:.8g} vs {cpu_err:.8g}: ok")

    # build_frame on the card against the CPU, same image and samples
    loc = mapper.sample_locations(0.1)
    fr_g = mapper.build_frame(0.1, images[1], loc1d=loc)
    fr_c = cpu_mapper.build_frame(0.1, images[1].cpu(), loc1d=loc.cpu())
    frame_diff = {
        name: rel_diff(getattr(fr_g, name), getattr(fr_c, name))
        for name in ("bias_flat", "jac_flat", "feat_pyr", "grad_pyr", "feat_desc_flat",
                     "src_feats", "avg_sq_bias")
    }
    frame_diff["packed_fg"] = rel_diff(fr_g.tables.packed_fg, fr_c.tables.packed_fg)
    # cuDNN's float32 convolution algorithms against the CPU's, through 22
    # partial-conv layers: 1e-3 of each tensor's max |value|
    if max(frame_diff.values()) > 1e-3:
        fail(f"build_frame card vs CPU: {frame_diff}")
    say("build_frame card vs CPU, max |d| / max |value|: "
        + ", ".join(f"{k} {v:.3g}" for k, v in frame_diff.items()) + ": ok")

    # the kernel at this path's steady-state shape, against its plain version
    k1 = reduce_at_path_shape(mapper, cfg, pyr, card, peaks, "mapper")

    # times after warm-up: build_frame (and its networks alone), steady steps
    def events_and_host(fn, reps):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps, start.elapsed_time(stop) / reps

    bf_host, bf_ev = events_and_host(lambda: mapper.build_frame(0.1, images[1]), 10)
    net_host, net_ev = events_and_host(lambda: mapper._networks(images[1]), 10)
    steady = [st for st in steps if st["keyframes"] > steady_from]
    step_host = float(np.mean([st["host_ms"] for st in steady]))
    step_ev = float(np.mean([st["event_ms"] for st in steady]))
    store_bytes = mapper.store.nbytes()
    runs = ", ".join(f"{st['host_ms']:.3f}" for st in steady)
    say(f"time [{card}] build_frame at {scene.images.shape[2]}x{scene.images.shape[3]}: "
        f"{bf_host:.3f} ms host clock, {bf_ev:.3f} ms CUDA events per frame, mean of 10 after "
        f"warm-up; the two networks alone {net_host:.3f} ms host, {net_ev:.3f} ms events")
    say(f"time [{card}] steady-state mapping_step (keyframes {steady[0]['keyframes']}-"
        f"{steady[-1]['keyframes']}): {step_host:.3f} ms host clock, {step_ev:.3f} ms CUDA events, "
        f"mean of {len(steady)} (host runs {runs}); "
        f"photometric E per step {[st['edges'][0] for st in steady]}, photo_reduce launches per step "
        f"{[st['iters'] for st in steady]}")
    say(f"mapper path [{card}]: keyframe store {store_bytes} bytes ({store_bytes / 2**30:.3f} GiB) "
        f"at capacity {cfg.max_keyframes}; peak device memory {torch.cuda.max_memory_allocated()} bytes")
    return dict(launches=launches, mapper=mapper, **k1)


def matcher_flips(card_sys, cpu_sys, kf: int, fr_card, fr_cpu):
    """The descriptor matching of a frame against keyframe kf on the card
    and on the CPU, from the same state -> (the number of keypoints whose
    match, cycle check or registration inlier differs; the largest float64
    gap, over the size |q|^2 + |p|^2 of the distance's terms, between the
    two nearest candidates of a query whose answer differs: the forward
    query where the match differs, else the backward one where the cycle
    check differs). The matcher takes argmin(|q|^2 + |p|^2 - 2 q.p) in
    float32, so a gap near 1e-7 is a tie the two devices' sums may break
    either way; an inlier that differs under an equal match follows from
    the registration seeing other matches. With no differing match the gap
    is infinite: nothing explains the difference."""
    mg_g = card_sys._match_geo(kf, fr_card)
    mg_c = cpu_sys._match_geo(kf, fr_cpu)
    desc0 = cpu_sys.store.row("feat_desc", kf).double()
    desc1 = fr_cpu.feat_desc_flat.double()

    def gap(query, table):
        d = torch.sum((table - query) ** 2, dim=-1)
        two = torch.topk(d, 2, largest=False)
        size = torch.sum(query**2) + torch.sum(table[two.indices] ** 2, dim=-1).max()
        return float((two.values[1] - two.values[0]) / size)

    m_g, m_c = mg_g.matches, mg_c.matches
    match = m_g.loc1d_1.cpu() != m_c.loc1d_1
    cycle = (m_g.valid.cpu() != m_c.valid) & ~match
    inlier = mg_g.inliers.cpu() != mg_c.inliers
    gaps = [gap(desc0[m_c.loc1d_0[k]], desc1) for k in match.nonzero()[:, 0].tolist()]
    gaps += [gap(desc1[m_c.loc1d_1[k]], desc0) for k in cycle.nonzero()[:, 0].tolist()]
    return int((match | cycle | inlier).sum()), max(gaps, default=float("inf"))


def slam_path(dev, card: str, peaks) -> dict:
    """Phase 7: the SLAM frontend at the published widths (see the module
    note). Returns what the kernels line needs."""
    from sage_slam_tpu_torch import convert, synthetic
    from sage_slam_tpu_torch.ops import photo_reduce as pr
    from sage_slam_tpu_torch.profile_slam import build_system, drive, summary_lines

    # every 4th frame is made a keyframe (profile_slam.KEYFRAME_EVERY);
    # frame 13 is held against the CPU
    n_frames, check_frame = synthetic.SLAM_FRAMES, 13
    system, scene, cfg = build_system(n_frames, device=dev)
    tcfg = cfg.tracker
    images = torch.from_numpy(scene.images).to(dev)
    timestamps = [0.1 * f for f in range(n_frames)]
    say(f"slam path: {n_frames} frames {tuple(scene.images.shape[2:])} -> {tuple(scene.mask_out.shape)}, "
        f"N={system.mapper.num_samples}, tracker {tcfg.max_num_iters} LM iterations (coarse-to-fine "
        f"{tcfg.coarse_to_fine}, soft gate {tcfg.soft_inlier_gate}), {tcfg.desc_num_keypoints} "
        f"keypoints, reprojection {tcfg.use_reprojection}; mapper window {cfg.mapper.window_size}, "
        f"store capacity {cfg.max_keyframes}")

    held = {}

    def frame_hook(f):
        """Before the check frame: build it, and keep clones of the system
        on the CPU and on the card, with copies of the frame, for the same
        call on the CPU and the matcher's comparison."""
        if f != check_frame:
            return None
        fr = system.mapper.build_frame(timestamps[f], images[f])
        held.update(cpu=system.clone("cpu"), frame=convert.to_device(fr, "cpu"),
                    card=system.clone(dev), card_frame=dataclasses.replace(fr))
        return fr

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pr.photo_reduce.launches = 0
    records = drive(system, images, timestamps, frame_hook)
    t0 = time.perf_counter()
    refine_err = system.refine_mapping(2)
    refine_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    launches = pr.photo_reduce.launches
    peak = torch.cuda.max_memory_allocated()
    map_iters = [r["map_iters"] for r in records if "map_iters" in r]
    iters_total = sum(map_iters) + system.refine_iterations

    for r in records:
        res = r["result"]
        say(f"  frame {r['frame']:2d}: keyframe {int(res.new_keyframe)} (forced {int(r['forced'])}) "
            f"lost {int(res.tracking_lost)} "
            f"LM {r['iters']:2d}, area {res.area_ratio:.4f} inlier {res.inlier_ratio:.4f} "
            f"motion {res.average_motion:.5f} desc {res.desc_inlier_ratio:.4f}, {r['host_ms']:.2f} ms host"
            + (f"; mapping_step {r['map_iters']} iterations {r['map_ms']:.2f} ms" if "map_ms" in r else ""))
    for line in summary_lines(records, card):
        say(line)
    say(f"time [{card}] refine_mapping(2): {refine_ms:.3f} ms host clock, {system.refine_iterations} LM "
        f"iterations, error {refine_err:.6g}; peak device memory {peak} bytes")
    say(f"slam path: photo_reduce launches {launches}, mapping LM iterations {iters_total} "
        f"(mapping_step {map_iters}, refine_mapping {system.refine_iterations})")
    if launches == 0 or launches != iters_total:
        fail(f"slam path: photo_reduce launched {launches} times for {iters_total} mapping LM iterations")
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        fail("slam path: TF32 is allowed after the networks ran")

    n = system.store.num_active
    v = system.store.variables
    tensors = [*v.pose, v.code, v.scale]
    tensors += [t for _, p in system.trajectory + system.finalized_trajectory() for t in p]
    tensors += [system.store.depth_map(i) for i in range(n)]
    if not all(bool(torch.isfinite(t).all()) for t in tensors):
        fail("slam path: a pose, depth map or variable is not finite")
    if len(system.trajectory) != n_frames:
        fail(f"slam path: {len(system.trajectory)} trajectory poses for {n_frames} frames")

    # the check frame on the CPU clone, from the state the card's call started from
    cpu = held["cpu"]
    res_c = cpu.process_frame(timestamps[check_frame], frame=held["frame"])
    rec = records[check_frame - 1]
    res_g = rec["result"]
    if (cpu.last_track_ref, cpu.last_track_iters, res_c.new_keyframe, res_c.tracking_lost) != (
            rec["ref"], rec["iters"], res_g.new_keyframe, res_g.tracking_lost):
        fail(f"process_frame card vs CPU: reference keyframe / LM iterations / keyframe / lost "
             f"{rec['ref']} / {rec['iters']} / {res_g.new_keyframe} / {res_g.tracking_lost} vs "
             f"{cpu.last_track_ref} / {cpu.last_track_iters} / {res_c.new_keyframe} / "
             f"{res_c.tracking_lost}")
    diffs = {
        "rot": float((res_g.pose.rot.cpu() - res_c.pose.rot).abs().max()),
        "trans": float((res_g.pose.trans.cpu() - res_c.pose.trans).abs().max()),
        **{name: abs(getattr(res_g, name) - getattr(res_c, name))
           for name in ("area_ratio", "inlier_ratio", "average_motion", "desc_inlier_ratio")},
    }
    # float32 roundoff of the tracker's sums on the card: pose and ratios
    # within 1e-4 absolute. The descriptor ratio counts matches: it may
    # differ only where a nearest-neighbour match is a float32 tie
    ties = ""
    if diffs["desc_inlier_ratio"] > 1e-4:
        flips, gap = matcher_flips(held["card"], cpu, rec["ref"], held["card_frame"],
                                   convert.to_device(held["card_frame"], "cpu"))
        if not flips or gap > 1e-5:
            fail(f"process_frame card vs CPU (frame {check_frame}): the descriptor ratio differs by "
                 f"{diffs['desc_inlier_ratio']}; {flips} keypoints differ, largest tie gap {gap}")
        ties = (f" (descriptor ratio {res_g.desc_inlier_ratio:.6f} vs {res_c.desc_inlier_ratio:.6f}: "
                f"{flips} keypoint(s) matched at a float32 tie of the nearest-neighbour distance, "
                f"largest gap {gap:.3g} of the distance's terms)")
        diffs.pop("desc_inlier_ratio")
    if max(diffs.values()) > 1e-4:
        fail(f"process_frame card vs CPU (frame {check_frame}): {diffs}")
    say(f"process_frame card vs CPU (frame {check_frame}, {rec['iters']} LM iterations, keyframe "
        f"{res_g.new_keyframe}): max |d| " + ", ".join(f"{k} {x:.3g}" for k, x in diffs.items())
        + ties + ": ok")

    k1 = reduce_at_path_shape(system.mapper, cfg, system.cam_pyr, card, peaks, "slam")
    return dict(launches=launches, **k1)


# LoopConfig fields the loop path relaxes: exactly those tests/test_slam_loop.py
# relaxes. With LoopConfig()'s gates the random networks close no loop: the
# revisit candidate (keyframe 10 against keyframe 0) stops at
# min_desc_inlier_ratio (PERF.md section 4 lists the cut and the values
# reached); the cycle and metric gates stay as configured
LOOP_RELAXED = dict(global_active_window=3, min_desc_inlier_ratio=0.0, min_area_ratio=0.0,
                    min_inlier_ratio=0.0, global_sim_ratio=0.0)
VOCABULARY = "eval_artifacts/bow_voc.npz"
# the loop methods' timing spans (SlamSystem)
LOOP_SPANS = ("detect_global_loop", "detect_local_loop", "verify_loop_7dof", "track_7dof",
              "close_global_loops")


def store_state(system) -> dict:
    """The store's poses and scales (rows [0, num_active)), reinitialize
    counts and links on the host, and the last pose-scale solve."""
    st = system.store
    n = st.num_active
    v = st.variables
    return dict(rot=v.pose.rot[:n].cpu(), trans=v.pose.trans[:n].cpu(), scale=v.scale[:n].cpu(),
                reinit=st.reinitialize_count.copy(), loop_links=set(st.global_loop_links),
                links={a: set(b) for a, b in st.links.items()}, graph=dict(system.last_pose_graph))


def state_diff(a: dict, b: dict) -> dict:
    """Largest pose difference and relative scale difference over the rows
    of ``b``."""
    n = b["rot"].shape[0]
    return dict(rot=float((a["rot"][:n] - b["rot"]).abs().max()),
                trans=float((a["trans"][:n] - b["trans"]).abs().max()),
                scale=float(((a["scale"][:n] - b["scale"]) / b["scale"]).abs().max()))


def hold_close(pre, kf: int, loops, card_after: dict, dev, gaussian: bool) -> str:
    """close_global_loops from ``pre`` (a CPU clone of the card's state just
    before that call) on the CPU, held against the card. With
    ``gaussian`` both sides solve with pose_graph_dcs_factor=0 (plain
    Gaussian loop edges, the reference's choice), the card side from a
    clone of ``pre``; otherwise the card side is the path's own call
    (``card_after``). Fails unless iterations, counts and links are equal,
    poses within 1e-4 and scales within 1e-4 relative, and, with
    ``gaussian``, unless the solve moved some pose or scale by over ten
    times that tolerance."""
    from sage_slam_tpu_torch import convert

    before = store_state(pre)
    cpu = pre.clone("cpu")
    if gaussian:
        card = pre.clone(dev)
        for side in (cpu, card):
            side.cfg = dataclasses.replace(side.cfg, loop=dataclasses.replace(side.cfg.loop,
                                                                              pose_graph_dcs_factor=0.0))
        card.close_global_loops(kf, loops)
        card_after = store_state(card)
        del card
    t0 = time.perf_counter()
    cpu.close_global_loops(kf, [convert.to_device(lp, "cpu") for lp in loops])
    cpu_s = time.perf_counter() - t0
    cpu_after = store_state(cpu)
    diffs = state_diff(card_after, cpu_after)
    moved = state_diff(card_after, before)
    same = all(card_after[k] == cpu_after[k] for k in ("loop_links", "links")) and (
        card_after["graph"]["iterations"] == cpu_after["graph"]["iterations"]
        and np.array_equal(card_after["reinit"], cpu_after["reinit"]))
    name = "Gaussian loop edges" if gaussian else "LoopConfig()'s Geman-McClure loop edges"
    g = card_after["graph"]
    # float32 roundoff through the pose-graph LM (other sum orders on the
    # card): poses 1e-4 absolute, scales 1e-4 relative
    if not same or max(diffs.values()) > 1e-4:
        fail(f"close_global_loops ({name}, keyframe {kf}) card vs CPU: iterations {g['iterations']} vs "
             f"{cpu_after['graph']['iterations']}, same counts/links {same}, {diffs}")
    if gaussian and max(moved.values()) <= 1e-3:
        fail(f"close_global_loops ({name}, keyframe {kf}): the solve moved no pose or scale by more than "
             f"1e-3 ({moved}), so the card-vs-CPU hold could not fail")
    return (f"close_global_loops card vs CPU ({name}; keyframe {kf}, {len(loops)} loop(s) to "
            f"{[lp.id_ref for lp in loops]}, phi {g['dcs_phi']:.3g}, {g['iterations']} pose-graph iterations, "
            f"{g['edges']} edges; CPU {cpu_s:.3f} s): largest move from the state before "
            + ", ".join(f"{k} {x:.3g}" for k, x in moved.items()) + "; card vs CPU max |d| "
            + ", ".join(f"{k} {x:.3g}" for k, x in diffs.items())
            + "; reinitialize_count, global_loop_links and links equal: ok")


def loop_path(dev, card: str, peaks) -> dict:
    """Phase 8: loop closure and the threaded driver at the published widths
    (see the module note)."""
    from collections import Counter

    from sage_slam_tpu_torch import synthetic
    from sage_slam_tpu_torch.config import SlamConfig
    from sage_slam_tpu_torch.frontend.driver import SlamDriver
    from sage_slam_tpu_torch.loop import vocabulary
    from sage_slam_tpu_torch.ops import photo_reduce as pr
    from sage_slam_tpu_torch.profile_slam import KEYFRAME_EVERY, build_system
    from sage_slam_tpu_torch.utils import timing

    cfg = SlamConfig()
    cfg = dataclasses.replace(cfg, loop=dataclasses.replace(cfg.loop, **LOOP_RELAXED))
    scene = synthetic.loop_scene(height=cfg.net_input_size[0], width=cfg.net_input_size[1])
    n_frames = scene.images.shape[0]
    voc = vocabulary.load_npz_vocabulary(os.path.join(ROOT, VOCABULARY), device=dev)
    system, _, _ = build_system(n_frames, device=dev, scene=scene, voc=voc, cfg=cfg)
    images = torch.from_numpy(scene.images).to(dev)
    timestamps = [0.1 * f for f in range(n_frames)]
    lcfg = cfg.loop
    probe_from = SlamConfig().loop.global_active_window
    say(f"loop path: {n_frames} frames out and back (the last repeats frame 0's view) "
        f"{tuple(scene.images.shape[2:])} -> {tuple(scene.mask_out.shape)}, vocabulary {VOCABULARY} "
        f"({voc.descriptors.shape[0]} nodes, {voc.num_words} words, branching {voc.branching}, {voc.levels} "
        f"levels); LoopConfig: window {lcfg.global_active_window}, sim ratio {lcfg.global_sim_ratio}, "
        f"tracker {lcfg.tracking_max_num_iters} LM iterations, cycle and metric gates "
        f"{lcfg.verify_cycle}/{lcfg.verify_metric_trans}; relaxed {LOOP_RELAXED}; "
        f"store capacity {cfg.max_keyframes}")

    # CPU clones of the state before a global tick: until the first tick that
    # closes a loop, at the revisit (the last forced keyframe) and where
    # LoopConfig()'s own window admits a candidate. They are made with the
    # path's clock stopped; the holds and the probe run after the path
    revisit_frame = (n_frames - 1) // KEYFRAME_EVERY * KEYFRAME_EVERY
    holds, probes = {}, {}
    map_iters, closed, graphs, links_after, per_kf = [], [], [], [], []
    untimed = 0.0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pr.photo_reduce.launches = 0
    timing.reset()
    timing.enable(True, cuda_events=True)
    t_path = time.perf_counter()
    system.bootstrap(timestamps[0], images[0])
    for f in range(1, n_frames):
        system.force_keyframe = system.force_keyframe or f % KEYFRAME_EVERY == 0
        res = system.process_frame(timestamps[f], images[f])
        if not res.new_keyframe:
            continue
        kf = res.keyframe_id
        system.mapper.mapping_step()
        map_iters.append(system.mapper.last_step_iters)
        n_links = sum(len(v) for v in system.store.links.values())
        local = system.local_loop_tick()
        pre = None
        if "first" not in holds or f == revisit_frame or kf >= probe_from:
            t0 = time.perf_counter()
            pre = system.clone("cpu")
            untimed += time.perf_counter() - t0
        n_tracks = len(system.loop_track_iters)
        loops = system.global_loop_tick()
        per_kf.append((kf, local, [lp.id_ref for lp in loops], system.loop_track_iters[n_tracks:]))
        if kf >= probe_from:
            probes[kf] = pre
        if loops:
            closed.append((kf, [lp.id_ref for lp in loops]))
            graphs.append(dict(system.last_pose_graph))
            for name in [n for n, want in (("first", "first" not in holds), ("revisit", f == revisit_frame))
                         if want]:
                holds[name] = (pre, kf, loops, store_state(system))
        if sum(len(v) for v in system.store.links.values()) > n_links:
            # a loop link: one more mapping_step, over the loop's edges
            system.mapper.mapping_step()
            map_iters.append(system.mapper.last_step_iters)
            links_after.append((kf, [lp.id_ref for lp in loops], list(system.mapper.last_step_photo_pairs)))
    refine_err = system.refine_mapping(2)
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t_path - untimed
    timing.enable(False)
    launches = pr.photo_reduce.launches
    peak = torch.cuda.max_memory_allocated()
    iters_total = sum(map_iters) + system.refine_iterations
    n_kf = system.store.num_active
    spans = {name: timing.calls(name) for name in LOOP_SPANS}

    say(f"loop path: {n_kf} keyframes, global loops closed {closed}, mapping LM iterations {iters_total} "
        f"(steps {map_iters}, refine_mapping {system.refine_iterations}, error {refine_err:.6g}), "
        f"photo_reduce launches {launches}; {path_s:.3f} s (clones for the holds not counted)")
    rejections = system.loop_rejections
    say(f"loop path gate rejections: {dict(Counter(r[2] for r in rejections))}; "
        + "; ".join(f"keyframe {q} candidate {r}: {gate} {v if v is None else f'{v:.4g}'} (limit {lim:.4g})"
                    for q, r, gate, v, lim in rejections))
    # one detect_global_loop and one detect_local_loop per keyframe after the
    # first, in keyframe order
    for (kf, local, found, tracks), (g_ms, g_ev), (l_ms, _) in zip(
            per_kf, spans["detect_global_loop"], spans["detect_local_loop"]):
        say(f"  keyframe {kf}: local loop {local.id_ref if local.detected else 'none'} ({l_ms:.3f} ms host); "
            f"global loops {found}, detect_global_loop {g_ms:.3f} ms host ({g_ev:.3f} ms CUDA events), "
            f"{len(tracks)} 7-DoF tracks of {tracks} LM iterations")
    tracks = system.loop_track_iters
    for name in LOOP_SPANS:
        runs = spans[name]
        host = [r[0] for r in runs]
        extra = ""
        if name == "track_7dof" and tracks:
            extra = (f"; {len(tracks)} tracks, {np.mean(tracks):.1f} LM iterations per track, "
                     f"{sum(host) / max(sum(tracks), 1):.3f} ms per iteration")
        if name == "close_global_loops":
            extra = (f"; pose-graph iterations {[g['iterations'] for g in graphs]}, edges "
                     f"{[g['edges'] for g in graphs]}, Geman-McClure phi {[g['dcs_phi'] for g in graphs]}")
        say(f"time [{card}] {name}: {len(runs)} calls, {np.mean(host):.3f} ms host clock (runs {min(host):.3f}-"
            f"{max(host):.3f}), {np.mean([r[1] for r in runs]):.3f} ms CUDA events{extra}" if runs
            else f"time [{card}] {name}: no call")
    say(f"loop path [{card}]: peak device memory {peak} bytes")

    if not closed:
        fail("loop path: no global loop was detected and closed")
    if not links_after or not all(
            any((kf, r) in edges or (r, kf) in edges for r in refs) for kf, refs, edges in links_after if refs):
        fail(f"loop path: the mapping_step after a loop link did not hold its photometric edges {links_after}")
    if launches == 0 or launches != iters_total:
        fail(f"loop path: photo_reduce launched {launches} times for {iters_total} mapping LM iterations")
    v = system.store.variables
    tensors = [*v.pose, v.code, v.scale] + [system.store.depth_map(i) for i in range(n_kf)]
    if not all(bool(torch.isfinite(t).all()) for t in tensors):
        fail("loop path: a pose, depth map or variable is not finite")

    # LoopConfig()'s own gates, where its window admits a candidate, on the
    # state each tick started from (nothing is closed)
    for kf, pre in probes.items():
        pre.cfg = dataclasses.replace(pre.cfg, loop=SlamConfig().loop)
        first = len(pre.loop_rejections)
        found = pre.detect_global_loop(kf)
        say(f"loop path, LoopConfig()'s own gates at keyframe {kf}: loops {[lp.id_ref for lp in found]}; "
            f"rejections {pre.loop_rejections[first:]}")
        pre.cfg = cfg
    del probes

    # the held close_global_loops calls on the CPU, from the same state: as
    # configured, and with Gaussian loop edges, which move the graph
    for name, (pre, kf, loops, card_after) in holds.items():
        say(f"{name}: " + hold_close(pre, kf, loops, card_after, dev, gaussian=False))
        say(f"{name}: " + hold_close(pre, kf, loops, card_after, dev, gaussian=True))
    del holds

    k1 = reduce_at_path_shape(system.mapper, cfg, system.cam_pyr, card, peaks, "loop")
    del system
    torch.cuda.empty_cache()

    # the threaded driver on a fresh system over the same scene
    tsys, _, _ = build_system(n_frames, device=dev, scene=scene, voc=voc, cfg=cfg)
    driver = SlamDriver(tsys, use_native_threads=True)

    def force(f):
        tsys.force_keyframe = tsys.force_keyframe or (f > 0 and f % KEYFRAME_EVERY == 0)

    timing.reset()
    timing.enable(True)
    before = pr.photo_reduce.launches
    t0 = time.perf_counter()
    try:
        results = driver.run(synthetic.SceneSource(scene, before_frame=force))
    except Exception as exc:  # noqa: BLE001 - the phase fails on any worker or frame error
        fail(f"threaded driver: {type(exc).__name__}: {exc} (cause {exc.__cause__!r})")
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    timing.enable(False)
    # the frame loop launches no K1; refine_mapping once per LM iteration
    worker_launches = pr.photo_reduce.launches - before - tsys.refine_iterations
    n = tsys.store.num_active
    v = tsys.store.variables
    tensors = [*v.pose, v.scale] + [tsys.store.depth_map(i) for i in range(n)]
    if not (tsys.store.local_loop_searched[:n].all() and tsys.store.global_loop_searched[:n].all()):
        fail("threaded driver: a keyframe was not searched by both loop backends")
    if not all(bool(torch.isfinite(t).all()) for t in tensors):
        fail("threaded driver: a pose, scale or depth map is not finite")
    if worker_launches <= 0:
        fail("threaded driver: the mapping worker launched photo_reduce no time")
    say(f"time [{card}] threaded SlamDriver.run: {len(results) + 1} frames in {run_s:.3f} s = "
        f"{(len(results) + 1) / run_s:.3f} frames/s (the drain and refine_mapping included); {n} keyframes, "
        f"mapping worker ticks {len(timing.calls('mapping_tick'))} with {worker_launches} photo_reduce "
        f"launches, global loops {sorted(tsys.global_loops)}")
    for line in timing.report().splitlines():
        say(f"  timing [{card}] {line}")
    return dict(launches=launches, driver_launches=worker_launches, **k1)


# phase 9: the demo CLI over eval_artifacts/EVAL.md's Bowl3D orbit at
# eval_artifacts/slam_config.json's widths. The cuts: random weights, and
# the depth: the orbit's first 32 frames (31/63 of an orbit, so each frame
# moves as far as in the 64-frame orbit; no revisit), since phase 11 runs
# the whole orbit through make_eval
DEMO_URL = ("bowl3d://?num_frames=32&height=128&width=160&seed=0&orbit_radius=0.22&rot_amp=0.25"
            "&mask_margin=6&orbits=0.49206349206349204")
DEMO_CONFIG = "eval_artifacts/slam_config.json"
DEMO_NETCFG = "eval_artifacts/net_netcfg.json"
DEMO_RUN_DIR = "_runs/demo"
# KeyframeConfig fields relaxed where the random networks make fewer than 2
# keyframes by their own ratios (K1 would never launch); empty: none relaxed
DEMO_KEYFRAME_RELAXED: dict = {}
# the store's rows in a checkpoint; load_state rebuilds src_feats and the
# store's FrameTables from them
STORE_ROWS = ("loc1d", "homo", "bias_flat", "jac_flat", "feat_pyr", "grad_pyr", "feat_desc", "avg_sq_bias")


def check_tum(path: str, trajectory, label: str) -> None:
    """The TUM file read back through read_tum equals ``trajectory`` to the
    file's printed precision: timestamps 6 decimals, translations and
    quaternion components 8 (rotations compared with the rotation of the
    unrounded quaternion, to 1e-7)."""
    from sage_slam_tpu_torch.io import tum_io

    back = tum_io.read_tum(path)
    if len(back) != len(trajectory):
        fail(f"{label}: {len(back)} poses in {path}, {len(trajectory)} in the system")
    rots = torch.stack([p.rot for _, p in trajectory]).cpu().numpy().astype(np.float64)
    trans = torch.stack([p.trans for _, p in trajectory]).cpu().numpy().astype(np.float64)
    d_ts = max(abs(a[0] - ts) for a, (ts, _) in zip(back, trajectory))
    d_t = float(np.abs(np.stack([a[1] for a in back]) - trans).max())
    want = np.stack([tum_io.quaternion_to_rotation(tum_io.rotation_to_quaternion(r)) for r in rots])
    d_r = float(np.abs(np.stack([a[2] for a in back]) - want).max())
    if d_ts > 5.0001e-7 or d_t > 5.0001e-9 or d_r > 1e-7:
        fail(f"{label}: read_tum differs from the system beyond the printed precision "
             f"(timestamps {d_ts:.3g}, translations {d_t:.3g}, rotations {d_r:.3g})")
    say(f"{label}: read back: {len(back)} poses, max |d| timestamps {d_ts:.3g}, "
        f"translations {d_t:.3g}, rotations {d_r:.3g}: ok")


def hold_resume(system, path: str, dev) -> str:
    """save_state, then load_state into a fresh card system built the same
    way: every row and derived table equal bit for bit, the host state
    equal, and one further mapping_step on each with equal LM iterations
    and errors within 1e-5 relative."""
    from sage_slam_tpu_torch.frontend.slam import SlamSystem
    from sage_slam_tpu_torch.mapping import serialize

    if system.mapper.reproj_edges:
        fail("save/resume: the mapper holds reprojection edges (loop links), which the checkpoint "
             "format does not hold")
    t0 = time.perf_counter()
    serialize.save_state(path, system)
    save_s = time.perf_counter() - t0
    m = system.mapper
    fresh = SlamSystem(system.cfg, system.cam, m.mask.cpu().numpy(), m.depth_net, m.feat_net,
                       voc=system.voc, video_mask_in=m.mask_in.cpu().numpy(), device=dev)
    t0 = time.perf_counter()
    serialize.load_state(path, fresh)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    a, b = system.store, fresh.store
    pairs = [(f"variables.{k}", x, y) for k, x, y in zip(
        ("rot", "trans", "code", "scale"), (*a.variables.pose, a.variables.code, a.variables.scale),
        (*b.variables.pose, b.variables.code, b.variables.scale))]
    if a.tables is None or b.tables is None:
        fail("save/resume: a store without its tables")
    pairs += [(k, getattr(a, k), getattr(b, k)) for k in STORE_ROWS + ("src_feats",)]
    ta, tb = a.tables.leaves(), b.tables.leaves()
    pairs += [(f"tables[{i}]", x, y) for i, ((x, _), (y, _)) in enumerate(zip(ta, tb))]
    differ = [k for k, x, y in pairs if not torch.equal(x, y)]
    host = dict(num_active=(a.num_active, b.num_active), timestamps=(a.timestamps, b.timestamps),
                links=(a.links, b.links), loops=(a.global_loop_links, b.global_loop_links),
                reinit=(a.reinitialize_count.tolist(), b.reinitialize_count.tolist()),
                aux=(a.aux.tolist(), b.aux.tolist()), curr_kf=(system.curr_kf, fresh.curr_kf),
                photo=(m.photo_edges, fresh.mapper.photo_edges), geo=(m.geo_edges, fresh.mapper.geo_edges),
                photo_iters=(m.photo_edge_iters, fresh.mapper.photo_edge_iters),
                geo_iters=(m.geo_edge_iters, fresh.mapper.geo_edge_iters))
    differ += [k for k, (x, y) in host.items() if x != y]
    if differ or len(ta) != len(tb):
        fail(f"save/resume: the resumed store differs from the saved one in {differ}")
    err_a = m.mapping_step()
    it_a = m.last_step_iters
    err_b = fresh.mapper.mapping_step()
    it_b = fresh.mapper.last_step_iters
    rel = abs(err_b - err_a) / max(abs(err_a), 1e-30)
    if it_a != it_b or rel > 1e-5:
        fail(f"save/resume: the next mapping_step differs: saved {err_a} ({it_a} iterations), resumed "
             f"{err_b} ({it_b})")
    return (f"save/resume on the card: {os.path.getsize(path)} bytes (save {save_s:.3f} s, load and table "
            f"rebuild {load_s:.3f} s); {len(pairs)} row and table tensors and the host state equal bit for "
            f"bit; next mapping_step {err_a:.8g} vs {err_b:.8g} (rel {rel:.3g}), {it_a} vs {it_b} "
            f"iterations: ok")


def demo_path(dev, card: str, peaks) -> dict:
    """Phase 9: the demo CLI end to end (see the module note)."""
    import importlib.util
    import shutil
    from collections import Counter

    from sage_slam_tpu_torch import synthetic
    from sage_slam_tpu_torch.config import SlamConfig
    from sage_slam_tpu_torch.demo import run_slam
    from sage_slam_tpu_torch.eval import ate
    from sage_slam_tpu_torch.io import dataset, tum_io
    from sage_slam_tpu_torch.ops import photo_reduce as pr
    from sage_slam_tpu_torch.utils import timing

    run_dir = os.path.join(ROOT, DEMO_RUN_DIR)
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)
    cfg_path = os.path.join(ROOT, DEMO_CONFIG)
    if DEMO_KEYFRAME_RELAXED:
        cfg = SlamConfig.from_json(cfg_path)
        cfg = dataclasses.replace(cfg, keyframe=dataclasses.replace(cfg.keyframe, **DEMO_KEYFRAME_RELAXED))
        cfg_path = os.path.join(run_dir, "slam_config_relaxed.json")
        cfg.to_json(cfg_path)
    cfg = SlamConfig.from_json(cfg_path)
    h_in, w_in = cfg.net_input_size
    h_out, w_out = cfg.net_output_size
    data = dataset.from_url(DEMO_URL, num_frames=20, height=h_in, width=w_in)
    # the frames' generation alone (a host numpy raycast), off the run
    t0 = time.perf_counter()
    for i in range(data.n):
        data.render(i)
    gen_ms = (time.perf_counter() - t0) * 1e3 / data.n
    say(f"demo path: {DEMO_URL}: {data.n} frames {h_in}x{w_in} -> {h_out}x{w_out}, config {DEMO_CONFIG} "
        f"(store capacity {cfg.max_keyframes}, window {cfg.mapper.window_size}, N {cfg.mapper.pho_num_samples}), "
        f"networks {DEMO_NETCFG} (random, torch.Generator().manual_seed(0)), vocabulary {VOCABULARY}; "
        f"relaxed keyframe fields {DEMO_KEYFRAME_RELAXED or 'none'}; Bowl3D frame generation "
        f"{gen_ms:.3f} ms per frame (host numpy raycast, timed apart)")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pr.photo_reduce.launches = 0
    timing.reset()
    t0 = time.perf_counter()
    summary, system = run_slam.run([
        "--source_url", DEMO_URL, "--config", cfg_path, "--net_config", os.path.join(ROOT, DEMO_NETCFG),
        "--vocab_path", os.path.join(ROOT, VOCABULARY), "--save_keyframes", "--enable_timing",
        "--run_log_dir", run_dir,
    ])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    timing.enable(False)
    launches = pr.photo_reduce.launches
    peak = torch.cuda.max_memory_allocated()
    iters = system.mapper.step_iters_total
    per_frame = [ms for ms, _ in timing.calls("process_frame")]
    n = system.store.num_active
    rejections = Counter(r[2] for r in system.loop_rejections)
    plot = os.path.exists(os.path.join(run_dir, "map.png"))
    has_mpl = importlib.util.find_spec("matplotlib") is not None
    say(f"time [{card}] demo CLI (threaded): {summary['frames']} frames in {summary['wall_time_s']} s = "
        f"{summary['fps']} frames/s (host clock around run_slam.run, writing included: {run_s:.3f} s); "
        f"process_frame {np.mean(per_frame):.3f} ms on average over {len(per_frame)} frames (runs "
        f"{min(per_frame):.3f}-{max(per_frame):.3f}); {n} keyframes, {summary['global_loops']} global loops, "
        f"refine_mapping {summary['refine_iterations']} LM iterations; loop gate rejections "
        f"{dict(rejections)}; mapping LM iterations {iters}, photo_reduce launches {launches}; peak "
        f"device memory {peak} bytes; map.png {'written' if plot else 'not written'} (matplotlib "
        f"{'present' if has_mpl else 'absent'})")
    for line in timing.report().splitlines():
        say(f"  timing [{card}] {line}")
    if plot != has_mpl:
        fail(f"demo path: map.png written {plot} with matplotlib present {has_mpl}")
    if summary["frames"] != data.n or n < 2:
        fail(f"demo path: {summary['frames']} frames and {n} keyframes (want {data.n} and at least 2)")
    if launches == 0 or launches != iters:
        fail(f"demo path: photo_reduce launched {launches} times for {iters} mapping LM iterations")
    v = system.store.variables
    depths = torch.stack([system.store.depth_map(i) for i in range(n)])
    tensors = [*v.pose, v.code, v.scale, depths] + [p.trans for _, p in system.trajectory]
    if not all(bool(torch.isfinite(t).all()) for t in tensors):
        fail("demo path: a pose, depth map or variable is not finite")
    for name, traj in (("trajectory.txt", system.finalized_trajectory()),
                       ("trajectory_tracked.txt", system.trajectory),
                       ("keyframe_trajectory.txt", system.keyframe_trajectory())):
        check_tum(os.path.join(run_dir, name), traj, f"demo path {name}")
    npys = sorted(f for f in os.listdir(run_dir) if f.startswith("kf_") and f.endswith("_depth.npy"))
    if npys != [f"kf_{i:04d}_depth.npy" for i in range(n)]:
        fail(f"demo path: keyframe depth files {npys} for {n} keyframes")
    saved = np.stack([np.load(os.path.join(run_dir, f)) for f in npys])
    np.testing.assert_allclose(saved, depths.cpu().numpy().reshape(n, h_out, w_out), rtol=1e-6)

    # against Bowl3D's exact poses and depths (random weights: no bound)
    gt = np.stack([data.pose_at(i)[:3, 3] for i in range(data.n)])
    span = float(np.linalg.norm(gt.max(0) - gt.min(0)))
    for name in ("trajectory.txt", "trajectory_tracked.txt", "keyframe_trajectory.txt"):
        traj = tum_io.read_tum(os.path.join(run_dir, name))
        est = np.stack([t for _, t, _ in traj])
        ref = gt[[int(round(ts)) for ts, _, _ in traj]]
        sim3, se3 = ate.ate_rmse(est, ref, "sim3"), ate.ate_rmse(est, ref, "se3")
        say(f"demo path vs ground truth [{card}] {name}: {len(traj)} poses, Sim3-ATE {sim3:.6f} "
            f"({sim3 / span:.4%} of the span {span:.6f}), SE3-ATE {se3:.6f} ({se3 / span:.4%})")
    mask = data.mask(h_out, w_out)
    kf_ts = system.store.timestamps[:n]
    rmse = [ate.depth_rmse(saved[i], data.render(int(round(ts)), h_out, w_out)[1], mask)
            for i, ts in enumerate(kf_ts)]
    say(f"demo path vs ground truth [{card}]: keyframe depth RMSE (scale-aligned) mean {np.mean(rmse):.6f}, "
        f"max {np.max(rmse):.6f}: " + ", ".join(f"kf {i} (frame {int(ts)}) {r:.5f}"
                                              for i, (ts, r) in enumerate(zip(kf_ts, rmse))))

    k1 = reduce_at_path_shape(system.mapper, cfg, system.cam_pyr, card, peaks, "demo")
    say(hold_resume(system, os.path.join(run_dir, "state.npz"), dev))

    # the ground-truth hold that can fail: the port's counterpart of
    # tests/test_ate_regression.py's perfect-prior run, on its inputs (the
    # JAX test's sample draws), held to its bounds
    for label, draws in (("the JAX test's draws", synthetic.PERFECT_PRIOR_DRAWS), ("the port's own draws", None)):
        psys, pdata = synthetic.perfect_prior_system(device=dev, draws=draws)
        t0 = time.perf_counter()
        r = synthetic.perfect_prior_run(psys, pdata)
        pp_s = time.perf_counter() - t0
        say(f"perfect-prior run on the card ({label}, {r['keyframes']} keyframes, {pp_s:.3f} s): frame "
            f"Sim3-ATE {r['frame_sim3']:.6f} = {r['frame_sim3'] / r['span']:.4%} of the span, keyframe "
            f"{r['keyframe_sim3']:.6f} = {r['keyframe_sim3'] / r['span']:.4%}, depth RMSE max "
            f"{max(r['depth_rmse']):.3g}, tracking lost {sum(r['tracking_lost'])}")
        if draws is not None and not (
                not any(r["tracking_lost"]) and r["frame_sim3"] < 0.055 * r["span"]
                and r["keyframe_sim3"] < 0.05 * r["span"] and max(r["depth_rmse"]) < 0.05
                and r["travel"] > 1e-3):
            fail(f"perfect-prior run: outside test_ate_regression's bounds (5.5% / 5.0% of the span, depth "
                 f"RMSE 0.05): {r}")
    del system, psys
    torch.cuda.empty_cache()
    return dict(launches=launches, **k1)


# phase 10: the training slice at demo/make_eval.py's widths on its first
# training orbit (make_eval.py:78-117); the cuts: 6 triplets (5 trained, 1
# held out), 2 epochs (1 separate, 1 joint)
TRAIN_BOWL = dict(num_frames=64, height=128, width=160, seed=0, orbit_radius=0.16, rot_amp=0.15,
                  mask_margin=6)
TRAIN_TRIPLETS = 6
TRAIN_RUN_DIR = "_runs/train"
# K1's backward at the training shape (E=1, L=4, C=16, N=128) and the bench
# shape (E=24, N=3072)
BACKWARD_SHAPES = (((1, 4, 16, 128, 29), "training shape"), ((24, 4, 16, 3072, 29), "bench shape"))
# the card's joint train step against the CPU's: float32 roundoff of cuDNN's
# and the CPU's convolutions through two full-width U-Nets, forward and
# backward, and of the LM's solves. The loss to 1e-3 relative; the aux
# scalars to 1e-2 relative (depth, g_adv and d_loss read the BA's dense
# depth, which random networks drive to |values| of ~200, where 1e-5
# relative differences of the code grow); the parameter updates to 1e-2 of
# the largest update of any parameter, and the update vector to 1e-2 in L2.
# Each generator leaf's gradient of the same joint loss, card against CPU,
# relative to that leaf's own largest |gradient| on the CPU: the BA scalars
# and log_sigma (their gradients reach them through K1's backward, the
# weights' cotangent among them) to TRAIN_HOLD_SCALAR, each network tensor
# to TRAIN_HOLD_LEAF (small leaves of a large gradient carry the most
# roundoff). On an H100 80GB HBM3 at 700 W the scalars read 9.4e-7 to
# 7.3e-3 and the network leaves up to 1.8e-2 (5.7e-2 in an earlier call);
# a wrong gradient reads O(1). A network leaf whose gradient is zero but
# for roundoff is exempt: its largest |gradient| on the CPU lies below
# float32's epsilon times the gradient's L2 norm (a conv bias before a
# one-channel GroupNorm group, which subtracts that channel's own mean).
TRAIN_HOLD_LOSS, TRAIN_HOLD_AUX, TRAIN_HOLD_UPDATE = 1e-3, 1e-2, 1e-2
TRAIN_HOLD_SCALAR, TRAIN_HOLD_LEAF = 2e-2, 2.5e-1


def reduce_backward_check(dev, shape, soft: bool, seed: int, label: str) -> dict:
    """K1's closed-form backward on the card (photo_reduce on tensors that
    carry a graph: K1 forward, PhotoReduceFn backward) against autograd
    through photo_reduce_ref on the same inputs and cotangents, every input's
    and the weights' cotangent. Returns the errors and, timed, the backward
    alone beside the plain version's backward."""
    from sage_slam_tpu_torch.ops import photo_reduce as pr

    e, lv, c, n, dim = shape
    ratios = tuple((0.5**lvl, 0.5**lvl) for lvl in range(lv))
    ins = [t.requires_grad_(True) for t in reduce_inputs(e, lv, c, n, dim, soft, seed, dev)]
    w = torch.tensor(WEIGHTS[:lv], device=dev, requires_grad=True)
    wrt = [*ins, w]
    launches, calls = pr.photo_reduce.launches, pr.photo_reduce.backward_calls
    outs = pr.photo_reduce(*ins, w, ratios)
    gen = torch.Generator().manual_seed(seed)
    cots = [torch.randn(o.shape, generator=gen).to(dev) for o in outs]
    got = torch.autograd.grad(outs, wrt, cots)
    if pr.photo_reduce.launches != launches + 1 or pr.photo_reduce.backward_calls != calls + 1:
        fail(f"K1 backward {label}: the graph did not go through the kernel and PhotoReduceFn")
    ref_outs = pr.photo_reduce_ref(*ins, w, ratios)
    ref = torch.autograd.grad(ref_outs, wrt, cots, retain_graph=True)
    names = ("fgs", "f0_cm", "gate", "kx", "ky", "weights")
    abs_err = rel_err = 0.0
    for name, a, b in zip(names, got, ref):
        scale = float(b.abs().max())
        d = float((a - b).abs().max())
        if not d <= 1e-4 * scale:
            fail(f"K1 backward {label}: d{name} differs from autograd through the plain version by "
                 f"{d} (max |value| {scale}, tolerance 1e-4 of it)")
        abs_err, rel_err = max(abs_err, d), max(rel_err, d / max(scale, 1e-30))
    for name in ("fgs", "kx", "weights"):
        if not float(got[names.index(name)].abs().max()) > 0:
            fail(f"K1 backward {label}: d{name} is zero on the card")
    plain_in = [t.detach() for t in wrt]

    def run_backward():
        pr.photo_reduce_backward(*plain_in, ratios, *cots)

    def run_plain_backward():
        torch.autograd.grad(ref_outs, wrt, cots, retain_graph=True)

    for fn in (run_backward, run_plain_backward):
        fn()
    torch.cuda.synchronize()
    ms = device_ms(run_backward, 20)
    plain_ms = device_ms(run_plain_backward, 20)
    ev_ms = cuda_ms(run_backward, 20)
    pr.photo_reduce.launches, pr.photo_reduce.backward_calls = launches, calls
    return dict(abs_err=abs_err, rel_err=rel_err, ms=ms, plain_ms=plain_ms, events_ms=ev_ms)


def time_steps(fn, reps: int = 3):
    """Host-clock and CUDA-event ms of fn() after one warm-up call."""
    fn()
    host, events = [], []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        events.append(start.elapsed_time(stop))
    return float(np.mean(host)), float(np.mean(events)), host


def train_hold(state, triplet, pyr, tcfg, dev) -> str:
    """One joint train step on the card against the same step on a CPU copy:
    same parameters, batch and injected sample ids; and each generator
    leaf's gradient of the joint loss, card against CPU."""
    from sage_slam_tpu_torch.training import diff_ba, train

    ids = train.draw_sample_ids(torch.Generator().manual_seed(7), pyr[0].num_pixels,
                                tcfg.num_photo_samples)
    loss_fn = train.make_loss_fn(pyr, tcfg, True)
    # every branch of the BA's unroll in each gradient pass (ba_optimize's
    # record: the state selections' flags, the scale clamps, the zeroed
    # solutions, the backward clips): card and CPU gradients are of the
    # same function only when they agree
    records = []

    def generator_grads(st, batch):
        gen = train.param_leaves(st.params, with_disc=False)
        diff_ba.ba_optimize.record = []
        try:
            grads = torch.autograd.grad(loss_fn(st.params, batch, ids)[0], [t for _, t in gen],
                                        allow_unused=True)
            records.append(diff_ba.branch_record(diff_ba.ba_optimize.record))
        finally:
            diff_ba.ba_optimize.record = None
        return [(torch.zeros_like(t) if g is None else g.detach()).cpu()
                for (_, t), g in zip(gen, grads)]

    out = []
    for where in (dev, torch.device("cpu")):
        st = train.clone_state(state, where)
        batch = train.triplet_to_batch(triplet, triplet.camera, where)
        grads = generator_grads(st, batch)
        if where == dev:  # the card's gradient again, against itself
            grads_again = generator_grads(st, batch)
        before = [t.detach().clone() for _, t in train.param_leaves(st.params)]
        step = train.make_train_step(pyr, tcfg, True, tcfg.joint_lr_factor)
        st, loss, aux = step(st, batch, ids=ids)
        after = [t.detach() for _, t in train.param_leaves(st.params)]
        out.append((float(loss), {k: float(v) for k, v in aux.items()},
                    [(a - b).cpu() for a, b in zip(after, before)], grads))
    (lg, ag, dg, gg), (lc, ac, dc, gc) = out
    branches = ("select", "clamp", "zeroed", "clipped")
    decisions = [{k: r.get(k, []) for k in branches} for r in records]
    same_branch = decisions[0] == decisions[1] == decisions[2]
    bits = lambda d: "/".join(k + " " + ("".join("1" if x else "0" for x in d[k]) or "-")  # noqa: E731
                              for k in branches)
    # the largest condition number among the damped systems whose solution
    # reaches the returned state (card's first pass, CPU)
    cond_taken = [max((c for c, t in zip(r.get("cond", []), r.get("taken", [])) if t), default=None)
                  for r in (records[0], records[2])]
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)  # noqa: E731
    loss_rel = rel(lg, lc)
    aux_key = max(ac, key=lambda k: rel(ag[k], ac[k]))
    aux_rel = rel(ag[aux_key], ac[aux_key])
    names = [n for n, _ in train.param_leaves(state.params)]
    top = max(float(b.abs().max()) for b in dc)
    diffs = [float((a - b).abs().max()) for a, b in zip(dg, dc)]
    worst = int(np.argmax(diffs))
    l2 = float(torch.sqrt(sum(((a - b).double() ** 2).sum() for a, b in zip(dg, dc)))
               / torch.sqrt(sum((b.double() ** 2).sum() for b in dc)))

    # each generator leaf's gradient against its own largest |gradient|
    gen_names = [n for n, _ in train.param_leaves(state.params, with_disc=False)]
    g_norm = float(torch.sqrt(sum((g.double() ** 2).sum() for g in gc)))
    floor = float(np.finfo(np.float32).eps) * g_norm
    leaves = []
    for n, a, b in zip(gen_names, gg, gc):
        own = float(b.abs().max())
        d = float((a - b).abs().max())
        scalar = n.startswith("ba.") or n == "log_sigma"
        leaves.append(dict(name=n, own=own, diff=d, rel=d / own if own > 0 else (0.0 if d == 0 else np.inf),
                           exempt=own <= floor and not scalar, scalar=scalar))
    exempt = [r for r in leaves if r["exempt"]]
    held = [r for r in leaves if not r["exempt"]]
    bad = [r for r in held if not r["rel"] <= (TRAIN_HOLD_SCALAR if r["scalar"] else TRAIN_HOLD_LEAF)]
    # the card's second pass against its first, held as the CPU is
    again = {n: float((a - b).abs().max()) / r["own"] if r["own"] > 0 else 0.0
             for n, a, b, r in zip(gen_names, grads_again, gg, leaves) if not r["exempt"]}
    bad += [dict(name=f"{n} (card against itself)", rel=v) for n, v in again.items()
            if not v <= (TRAIN_HOLD_SCALAR if n.startswith("ba.") or n == "log_sigma" else TRAIN_HOLD_LEAF)]
    worst_again = max(again, key=again.get)
    w_scalar = max((r for r in held if r["scalar"]), key=lambda r: r["rel"])
    w_leaf = max((r for r in held if not r["scalar"]), key=lambda r: r["rel"])
    line = (f"joint train step card vs CPU: loss {lg:.8g} vs {lc:.8g} (rel {loss_rel:.3g}, tolerance "
            f"{TRAIN_HOLD_LOSS}); worst aux {aux_key} {ag[aux_key]:.8g} vs {ac[aux_key]:.8g} (rel "
            f"{aux_rel:.3g}, tolerance {TRAIN_HOLD_AUX}); update difference {diffs[worst] / top:.3g} of the "
            f"largest update {top:.4g} (at {names[worst]}; tolerance {TRAIN_HOLD_UPDATE}), L2 {l2:.3g} "
            f"(tolerance {TRAIN_HOLD_UPDATE}); per-leaf gradients (|g| {g_norm:.6g}, roundoff floor "
            f"{floor:.3g}): worst scalar {w_scalar['name']} {w_scalar['rel']:.3g} of its |g| "
            f"{w_scalar['own']:.4g} (tolerance {TRAIN_HOLD_SCALAR}), "
            + ", ".join(f"{r['name']} {r['rel']:.3g}" for r in held if r["scalar"])
            + f"; worst network leaf {w_leaf['name']} {w_leaf['rel']:.3g} of its |g| {w_leaf['own']:.4g} "
            f"(tolerance {TRAIN_HOLD_LEAF}); exempt below the floor: "
            + (", ".join(f"{r['name']} |g| {r['own']:.3g}" for r in exempt) or "none")
            + f"; the card's gradient against itself: worst {worst_again} {again[worst_again]:.3g}"
            + f"; LM decisions (card, card again, CPU) {'equal' if same_branch else 'DIFFER'}: "
            + (bits(decisions[0]) if same_branch else " | ".join(bits(d) for d in decisions))
            + "; pre-clip cotangent norms (card, max_norm " + f"{tcfg.ba_bwd_clip}): "
            + (", ".join(f"{x:.4g}" for x in records[0].get("clip_norm", [])) or "none")
            + "; largest condition number of a system whose solution the gradient passes (card, "
            + "CPU): " + ", ".join("none" if c is None else f"{c:.4g}" for c in cond_taken))
    if not same_branch:
        fail(line + "; the card and the CPU took different LM decisions, so their gradients "
             "are of different branches")
    if bad or not (loss_rel <= TRAIN_HOLD_LOSS and aux_rel <= TRAIN_HOLD_AUX
                   and diffs[worst] <= TRAIN_HOLD_UPDATE * top and l2 <= TRAIN_HOLD_UPDATE):
        fail(line + "; over tolerance: " + ", ".join(f"{r['name']} {r['rel']:.3g}" for r in bad))
    return line + ": ok"


def train_path(dev, card: str, peaks) -> dict:
    """Phase 10: the training slice on the card (see the module note)."""
    import shutil

    from sage_slam_tpu_torch.geometry.camera import CameraPyramid
    from sage_slam_tpu_torch.io.dataset import Bowl3DInterface
    from sage_slam_tpu_torch.models import depth_network, feature_network
    from sage_slam_tpu_torch.models.partial_unet import load_torch_state_dict
    from sage_slam_tpu_torch.ops import photo_reduce as pr
    from sage_slam_tpu_torch.training import dataset as tds
    from sage_slam_tpu_torch.training import discriminator, export, train

    # 1. K1's gradient on the card
    bwd = {}
    for i, (shape, label) in enumerate(BACKWARD_SHAPES):
        for soft in (False, True):
            r = reduce_backward_check(dev, shape, soft, 40 + i, label)
            tag = f"{label} {'soft' if soft else 'binary'} gate"
            say(f"K1 backward vs autograd through the plain version [{card}] {tag} E={shape[0]} "
                f"N={shape[3]}: max abs {r['abs_err']:.4g}, max rel {r['rel_err']:.4g} (of each "
                f"cotangent's max |value|); backward {r['ms']:.4f} ms device (events "
                f"{r['events_ms']:.4f}), plain autograd backward {r['plain_ms']:.4f} ms: ok")
            bwd[(label, soft)] = r

    # K1 forward at the training shape: against its plain version, timed
    e, lv, c, n, dim = BACKWARD_SHAPES[0][0]
    ratios = tuple((0.5**lvl, 0.5**lvl) for lvl in range(lv))
    prep = reduce_inputs(e, lv, c, n, dim, False, 50, dev)
    k1 = k1_hold(prep, WEIGHTS, ratios, card, peaks, f"the training shape E={e} L={lv} C={c} N={n}",
                 binary=True)

    # 2. triplets on make_eval's first training orbit
    run_dir = os.path.join(ROOT, TRAIN_RUN_DIR)
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)
    t0 = time.perf_counter()
    arrays = Bowl3DInterface(**TRAIN_BOWL).to_arrays()
    render_s = time.perf_counter() - t0
    tcfg_t = tds.TripletConfig(num_keypoints=128, frame_interval=3, far_frame_interval=10,
                               use_rotation_aug=False)
    src = tds.ArraySequenceDataset(arrays, cfg=tcfg_t, out_hw=(64, 80), in_hw=(128, 160), seed=0)
    t0 = time.perf_counter()
    triplets = [src.sample() for _ in range(TRAIN_TRIPLETS)]
    triplet_s = time.perf_counter() - t0
    say(f"train path: Bowl3D {TRAIN_BOWL} rendered in {render_s:.3f} s; {len(triplets)} triplets in "
        f"{triplet_s:.3f} s on the {'cv2' if tds._HAS_CV2 else 'no-cv2 (numpy fallback)'} branch; "
        f"keypoints {[int(t.keypoints_src.size) for t in triplets]}, far-overlap valid "
        f"{[bool(t.far_overlap_valid) for t in triplets]}")

    # 3. the training run: epoch 0 separate, epoch 1 joint
    cam = triplets[0].camera
    depth_cfg = depth_network.DepthNetConfig(basis_inner=((128, 128, 16),))
    feat_cfg = feature_network.FeatureNetConfig()
    disc_cfg = discriminator.DiscConfig(img_height=64, img_width=80)
    tcfg = train.TrainConfig(pyramid_levels=4, ba_iters=2, num_photo_samples=128, eval_fraction=0.2,
                             cycle_steps=200, separate_train_epoch=1)
    pyr = CameraPyramid.build(cam, tcfg.pyramid_levels)
    init = train.init_state(torch.Generator().manual_seed(0), depth_cfg, feat_cfg, disc_cfg, tcfg, dev)
    init_leaves = [t.detach().clone() for _, t in train.param_leaves(init.params)]
    del init
    ckpt = os.path.join(run_dir, "ckpt.npz")
    log = os.path.join(run_dir, "scalars.jsonl")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pr.photo_reduce.launches = 0
    pr.photo_reduce.backward_calls = 0
    t0 = time.perf_counter()
    state, history = train.train(triplets, cam, depth_cfg, feat_cfg, disc_cfg, tcfg, num_epochs=2,
                                 seed=0, checkpoint_path=ckpt, log_path=log, device=dev)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches, bwd_calls = pr.photo_reduce.launches, pr.photo_reduce.backward_calls
    peak = torch.cuda.max_memory_allocated()
    n_train = TRAIN_TRIPLETS - 1
    per_step = tcfg.ba_iters * (1 + 3)
    say(f"train path: train() 2 epochs ({n_train} train + 1 eval triplets each) in {run_s:.3f} s; K1 "
        f"forward launches {launches} (want {per_step} x ({n_train} joint train steps + 1 joint eval "
        f"step) = {per_step * (n_train + 1)}), K1 backward calls {bwd_calls} (want {tcfg.ba_iters} per "
        f"joint train step = {tcfg.ba_iters * n_train}); peak device memory {peak} bytes")
    for h in history:
        say(f"  epoch {h['epoch']} {'joint' if h['joint'] else 'separate'} eval: "
            + ", ".join(f"{k} {v:.6g}" for k, v in h["eval"].items()))
    if launches != per_step * (n_train + 1):
        fail(f"train path: K1 launched {launches} times, want {per_step * (n_train + 1)}")
    if bwd_calls != tcfg.ba_iters * n_train:
        fail(f"train path: K1's backward ran {bwd_calls} times, want {tcfg.ba_iters * n_train}")
    if [h["joint"] for h in history] != [False, True] or "flow" not in history[1]["eval"]:
        fail(f"train path: history {history}")
    records = [json.loads(line) for line in open(log)]
    train_recs = [r for r in records if r["tag"] == "train"]
    if len(train_recs) != 2 * n_train or not all(
            np.isfinite(v) for r in records for k, v in r.items() if k not in ("tag", "step")):
        fail(f"train path: {len(train_recs)} train records or a non-finite logged value")
    if not all(np.isfinite(v) for h in history for v in h["eval"].values()):
        fail("train path: a non-finite eval loss")
    leaves = train.param_leaves(state.params)
    moved = {name: float((t.detach() - t0_).abs().max()) for (name, t), t0_ in zip(leaves, init_leaves)}
    if not all(np.isfinite(float(t.detach().abs().max())) for _, t in leaves):
        fail("train path: a parameter is not finite")
    for name in ("ba.photo_weight", "ba.geometry_term_weight", "log_sigma"):
        if not moved[name] > 0:
            fail(f"train path: {name} did not change")
    say(f"train path: {sum(v > 0 for v in moved.values())} of {len(moved)} parameter tensors changed; "
        f"ba.photo_weight {float(state.params['ba'].photo_weight.detach()):.8g}, log_sigma "
        f"{float(state.params['log_sigma'].detach()):.8g}: ok")

    # 4. the card against the CPU
    say(train_hold(state, triplets[0], pyr, tcfg, dev))

    # 5. export, the demo loaders, resume
    paths = export.export_networks(state, os.path.join(run_dir, "net"), depth_cfg, feat_cfg)
    d_cfg, f_cfg = export.load_net_configs(paths["netcfg"])
    dnet = depth_network.init_network(torch.Generator().manual_seed(0), d_cfg)
    fnet = feature_network.init_network(torch.Generator().manual_seed(0), f_cfg)
    load_torch_state_dict(dnet, dict(np.load(paths["depth"])))
    load_torch_state_dict(fnet, dict(np.load(paths["feat"])))
    ba2 = export.load_ba_params(paths["ba"], device=dev)
    if not all(torch.equal(a, b.detach()) for a, b in zip(ba2, state.params["ba"])):
        fail("export: the BA weights did not round-trip")
    from sage_slam_tpu_torch.config import SlamConfig
    from sage_slam_tpu_torch.mapping.mapper import Mapper

    scfg = dataclasses.replace(SlamConfig(), max_keyframes=2)
    batch = train.triplet_to_batch(triplets[0], cam, dev)
    frames = []
    for dn, fn in ((dnet, fnet), (state.params["depth"], state.params["feat"])):
        mapper = Mapper(scfg, pyr, triplets[0].mask, dn, fn,
                        video_mask_in=batch["mask_in"].cpu().numpy(), device=dev)
        with torch.no_grad():
            frames.append(mapper.build_frame(0.0, batch["image_src"], loc1d=torch.arange(128, device=dev)))
    for name in ("bias_flat", "jac_flat", "feat_pyr", "feat_desc_flat"):
        if not torch.equal(getattr(frames[0], name), getattr(frames[1], name)):
            fail(f"export: build_frame's {name} from the exported networks differs from the trained ones")
    resumed, hist2 = train.train(triplets, cam, depth_cfg, feat_cfg, disc_cfg, tcfg, num_epochs=2, seed=0,
                                 checkpoint_path=ckpt, resume=True, device=dev)
    if resumed.epoch != 2 or hist2 or not all(
            torch.equal(a.detach(), b.detach()) for (_, a), (_, b) in zip(
                train.param_leaves(resumed.params), leaves)):
        fail(f"resume: epoch {resumed.epoch}, {len(hist2)} epochs run, or parameters differ")
    say(f"export: {sorted(paths)} written, loaded through load_net_configs and load_torch_state_dict; "
        f"build_frame from them equals the trained networks' bit for bit; resume restores epoch "
        f"{resumed.epoch} and every parameter: ok")

    # 6. times per step after warm-up (on a copy; these launches are not counted)
    saved = pr.photo_reduce.launches, pr.photo_reduce.backward_calls
    st = train.clone_state(state)
    ids_gen = torch.Generator().manual_seed(3)
    times = {}
    for label, joint in (("separate", False), ("joint", True)):
        step = train.make_train_step(pyr, tcfg, joint, tcfg.joint_lr_factor if joint else 1.0)
        holder = [st]

        def run(step=step, holder=holder):
            holder[0] = step(holder[0], batch, generator=ids_gen)[0]

        times[label] = time_steps(run)
    ev = train.make_eval_step(pyr, tcfg, True)
    times["eval"] = time_steps(lambda: ev(st, batch, generator=ids_gen))
    pr.photo_reduce.launches, pr.photo_reduce.backward_calls = saved
    for label, (host, events, runs) in times.items():
        say(f"time [{card}] train path {label} step: {host:.3f} ms host clock, {events:.3f} ms CUDA "
            f"events (mean of 3 after a warm-up; host runs {', '.join(f'{x:.3f}' for x in runs)})")
    del state, st, frames
    torch.cuda.empty_cache()
    worst = max(bwd.values(), key=lambda r: r["rel_err"])
    return dict(launches=launches, backward_calls=bwd_calls, max_abs_err=k1["max_abs_err"],
                max_rel_err=k1["max_rel_err"], shape=[e, lv, c, n, dim], **k1["shape"],
                backward={
                    "route": "torch ops, closed form",
                    "source": "sage_slam_tpu_torch/ops/photo_reduce.py:photo_reduce_backward",
                    "calls": bwd_calls,
                    "max_abs_err": max(r["abs_err"] for r in bwd.values()),
                    "max_rel_err": worst["rel_err"],
                    "ms_training_shape": bwd[("training shape", False)]["ms"],
                    "plain_ms_training_shape": bwd[("training shape", False)]["plain_ms"],
                    "ms_bench_shape": bwd[("bench shape", False)]["ms"],
                    "plain_ms_bench_shape": bwd[("bench shape", False)]["plain_ms"],
                },
                step_ms={k: v[0] for k, v in times.items()},
                step_events_ms={k: v[1] for k, v in times.items()}, peak_bytes=peak)


# phase 11: dense and diagnostic eval. (b) demo/make_eval's chain at its
# operating point into the git-ignored _runs/make_eval, cut in depth only
# (MAKE_EVAL_CUTS); (a) its TSDF volume on the card against the CPU;
# (c) eval/error_budget's A and C rows over the 64-frame orbit of
# docs/error_budget_r05.json; (d) eval/gt_probe at docs/gt_probe_r05_64x80.json's
# configuration (128x160, 64 frames, stride 4: 16 keyframes)
MAKE_EVAL_RUN_DIR = "_runs/make_eval"
MAKE_EVAL_CUTS = ["--epochs", "4", "--train_triplets", "16", "--train_budget_s", "90"]
MAKE_EVAL_FILES = ("net_depth.npz", "net_feat.npz", "net_netcfg.json", "bow_voc.npz", "reconstruction.ply",
                   "report.json", "EVAL.md")
TSDF_FLIP_SHARE = 1e-3  # voxels that may differ next to a rounding boundary
ERROR_BUDGET_JAX = "docs/error_budget_r05.json"  # a TPU run's accuracy, printed beside, not a target
ERROR_BUDGET_STAGES = ("A_tracker_oracle", "C_refine_oracle")
GT_PROBE_JAX = "docs/gt_probe_r05_64x80.json"
GT_PROBE = dict(num_frames=64, height=128, width=160, stride=4, back=2)
GT_PROBE_SECTION_STEPS = 5
# grad_report on the card against the CPU: float32 roundoff of the
# photometric sums over 16 keyframes (other sum orders on the card)
GT_PROBE_GRAD_RTOL = 1e-4


def read_ply(path: str):
    """(vertices [V, 3], faces [F, 3]) of an ASCII PLY written by save_ply;
    fails on a malformed file."""
    with open(path) as f:
        lines = f.read().splitlines()
    if lines[:2] != ["ply", "format ascii 1.0"] or "end_header" not in lines:
        fail(f"{path}: not an ASCII PLY")
    head = lines[: lines.index("end_header")]
    nv = int(next(ln.split()[2] for ln in head if ln.startswith("element vertex")))
    nf = int(next(ln.split()[2] for ln in head if ln.startswith("element face")))
    body = lines[len(head) + 1:]
    if len(body) != nv + nf:
        fail(f"{path}: {len(body)} body lines for {nv} vertices and {nf} faces")
    verts = np.array([[float(x) for x in ln.split()] for ln in body[:nv]], np.float32).reshape(-1, 3)
    faces = np.array([[int(x) for x in ln.split()] for ln in body[nv:]], np.int64).reshape(-1, 4)
    if not (faces[:, 0] == 3).all():
        fail(f"{path}: a face is not a triangle")
    return verts, faces[:, 1:]


def make_eval_chain(dev, card: str) -> dict:
    """Phase 11(b): make_eval.run end to end and its artifacts checked."""
    import shutil

    from sage_slam_tpu_torch.demo import make_eval
    from sage_slam_tpu_torch.loop import vocabulary
    from sage_slam_tpu_torch.models import depth_network, feature_network
    from sage_slam_tpu_torch.models.partial_unet import load_torch_state_dict
    from sage_slam_tpu_torch.ops import photo_reduce as pr
    from sage_slam_tpu_torch.training.export import load_net_configs

    out = os.path.join(ROOT, MAKE_EVAL_RUN_DIR)
    shutil.rmtree(out, ignore_errors=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pr.photo_reduce.launches = 0
    t0 = time.perf_counter()
    report, system = make_eval.run(["--out_dir", out, "--separate_only", *MAKE_EVAL_CUTS])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = pr.photo_reduce.launches
    iters = system.mapper.step_iters_total
    peak = torch.cuda.max_memory_allocated()
    tr, sl, at, dp, me = (report[k] for k in ("training", "slam", "ate", "depth", "mesh"))
    say(f"make_eval [{card}]: {' '.join(MAKE_EVAL_CUTS)} --separate_only into {MAKE_EVAL_RUN_DIR}, "
        f"{run_s:.3f} s in all (report {report['wall_total_s']} s); training {tr['steps']} steps in "
        f"{tr['wall_s']} s, exported epoch {tr['best_epoch']} of {tr['epochs']}, eval depth "
        f"{tr['eval_first']['depth']} -> {tr['eval_best']['depth']}, rr {tr['eval_first']['rr']} -> "
        f"{tr['eval_best']['rr']}; demo {sl['frames']} frames at {sl['fps']} frames/s, {sl['keyframes']} "
        f"keyframes, {sl['global_loops']} global loops, loop gate rejections "
        f"{len(system.loop_rejections)}, refine {sl['refine_iterations']} LM iterations; frame Sim3-ATE "
        f"{at['sim3_pct_of_span']}% of the span {at['trajectory_span']}, keyframe {at['kf_sim3_pct_of_span']}%; "
        f"keyframe depth RMSE mean {dp['mean_kf_rmse']} max {dp['max_kf_rmse']}; mesh {me['vertices']} "
        f"vertices {me['faces']} faces; mapping LM iterations {iters}, photo_reduce launches {launches}; "
        f"peak device memory {peak} bytes; backend line {report['operating_point']['backend']!r}")
    if launches == 0 or launches != iters:
        fail(f"make_eval: photo_reduce launched {launches} times for {iters} mapping LM iterations")
    if report["operating_point"]["backend"] != card:
        fail(f"make_eval: backend {report['operating_point']['backend']!r}, the card is {card!r}")
    missing = [f for f in MAKE_EVAL_FILES if not os.path.isfile(os.path.join(out, f))]
    if missing:
        fail(f"make_eval: {missing} not written")
    run_dir = os.path.join(out, "slam_run")
    n = system.store.num_active
    if sl["frames"] != make_eval.eval_orbit(64)["num_frames"] or n < 2 or dp["keyframes"] != n:
        fail(f"make_eval: {sl['frames']} frames, {n} keyframes, {dp['keyframes']} depth rows")
    for name, traj in (("trajectory.txt", system.finalized_trajectory()),
                       ("keyframe_trajectory.txt", system.keyframe_trajectory())):
        check_tum(os.path.join(run_dir, name), traj, f"make_eval {name}")
    npys = sorted(f for f in os.listdir(run_dir) if f.startswith("kf_") and f.endswith("_depth.npy"))
    if npys != [f"kf_{i:04d}_depth.npy" for i in range(n)]:
        fail(f"make_eval: keyframe depth files {npys} for {n} keyframes")
    values = [at["sim3_rmse"], at["kf_sim3_rmse"], dp["mean_kf_rmse"], dp["max_kf_rmse"]]
    if not np.isfinite(values).all():
        fail(f"make_eval: a non-finite ATE or depth RMSE {values}")
    verts, faces = read_ply(os.path.join(out, "reconstruction.ply"))
    if len(faces) == 0 or faces.max() >= len(verts) or (len(verts), len(faces)) != (me["vertices"], me["faces"]):
        fail(f"make_eval: reconstruction.ply has {len(verts)} vertices and {len(faces)} faces (max index "
             f"{faces.max() if len(faces) else None}); the report says {me}")
    with open(os.path.join(out, "report.json")) as f:
        if json.load(f) != report:
            fail("make_eval: report.json differs from the returned report")
    with open(os.path.join(out, "EVAL.md")) as f:
        md = f.read()
    if f"Backend: **{card}**" not in md or "python -m sage_slam_tpu_torch.demo.make_eval" not in md:
        fail("make_eval: EVAL.md lacks the card's backend line or the port's regenerate line")
    voc = vocabulary.load_npz_vocabulary(os.path.join(out, "bow_voc.npz"), device=dev)
    d_cfg, f_cfg = load_net_configs(os.path.join(out, "net_netcfg.json"))
    dnet = depth_network.init_network(torch.Generator().manual_seed(0), d_cfg)
    fnet = feature_network.init_network(torch.Generator().manual_seed(0), f_cfg)
    load_torch_state_dict(dnet, dict(np.load(os.path.join(out, "net_depth.npz"))))
    load_torch_state_dict(fnet, dict(np.load(os.path.join(out, "net_feat.npz"))))
    for a, b in ((dnet, system.mapper.depth_net), (fnet, system.mapper.feat_net)):
        sb = b.state_dict()
        if not all(torch.equal(v, sb[k].cpu()) for k, v in a.state_dict().items()):
            fail("make_eval: the exported networks, loaded as the demo loads them, differ from the run's")
    say(f"make_eval: {', '.join(MAKE_EVAL_FILES)}, slam_run/ (TUM files read back, {n} depth files) and "
        f"fly_through/ written; reconstruction.ply parses ({len(verts)} vertices, {len(faces)} faces, max "
        f"index {faces.max()}); the exported networks load through load_net_configs and "
        f"load_torch_state_dict equal to the run's; the {voc.num_words}-word vocabulary loads: ok")
    return dict(report=report, system=system, launches=launches, run_dir=run_dir)


def tsdf_hold(kf, dev, card: str) -> dict:
    """Phase 11(a): make_eval's volume on the card against the same inputs
    on CPU tensors; the device time per integrate; the fly-through."""
    from sage_slam_tpu_torch.demo import make_eval
    from sage_slam_tpu_torch.eval import tsdf
    from sage_slam_tpu_torch.geometry.se3 import SE3

    dims = (96, 96, 96)
    vol = make_eval.fuse(kf, dims, device=dev)
    ref = make_eval.fuse(kf, dims, device="cpu")
    poses = [SE3(torch.as_tensor(r, dtype=torch.float32), torch.as_tensor(t, dtype=torch.float32))
             for r, t in kf.poses]
    near = np.zeros(dims, bool)
    for p, d in zip(poses, kf.depths):
        near |= tsdf.near_rounding_boundary(ref, d, p, kf.cam)
    t, w = vol.tsdf.cpu().numpy(), vol.weight.cpu().numpy()
    rt, rw = ref.tsdf.numpy(), ref.weight.numpy()
    far = ~near
    d_t, d_w = float(np.abs(t - rt)[far].max()), float(np.abs(w - rw)[far].max())
    flipped = int(((np.abs(t - rt) > 1e-5) | (np.abs(w - rw) > 1e-5)).sum())
    if d_t > 1e-5 or d_w > 1e-5:
        fail(f"tsdf: card and CPU differ by {d_t:.3g} (tsdf) and {d_w:.3g} (weight) away from a rounding boundary")
    if flipped > TSDF_FLIP_SHARE * t.size:
        fail(f"tsdf: {flipped} of {t.size} voxels flipped (limit {TSDF_FLIP_SHARE:.1%})")
    # device ms per integrate (CUDA events) over the keyframes, inputs on the card
    lo, voxel = make_eval.fusion_bounds(kf, dims)
    on_card = [(SE3(p.rot.to(dev), p.trans.to(dev)), torch.as_tensor(d, device=dev)) for p, d in zip(poses, kf.depths)]
    mask = torch.as_tensor(kf.mask, device=dev)
    runs = []
    for _ in range(2):  # the first is warm-up
        v = tsdf.TSDFVolume.create(lo, dims, voxel, device=dev)
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for p, d in on_card:
            v = tsdf.integrate(v, d, mask, p, kf.cam)
        stop.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(stop) / len(on_card))
    nbytes = sum(x.numel() * x.element_size() for x in (vol.tsdf, vol.weight, vol.origin))
    verts, faces = tsdf.marching_tetrahedra(vol)
    if len(faces) == 0 or faces.max() >= len(verts):
        fail(f"tsdf: the card volume's mesh has {len(verts)} vertices and {len(faces)} faces")
    fly = tsdf.fly_through(vol, kf.cam, poses, num_frames=8, point_size=2)
    h, w_ = kf.cam.height, kf.cam.width
    lit = [int((fr > 0).any(-1).sum()) for fr in fly]
    if len(fly) != 8 or any(fr.shape != (h, w_, 3) or fr.dtype != np.uint8 for fr in fly) or min(lit) == 0:
        fail(f"tsdf: fly_through gave {len(fly)} frames, lit pixels {lit}")
    say(f"tsdf [{card}]: {len(kf.depths)} keyframes into {dims} voxels of {voxel:.6f} on the card against "
        f"the CPU: max |d| {d_t:.3g} (tsdf), {d_w:.3g} (weight) on the {int(far.sum())} voxels away from a "
        f"rounding boundary; {flipped} voxels flipped of {t.size} ({flipped / t.size:.5%}; {int(near.sum())} "
        f"near a boundary): ok; integrate {runs[1]:.4f} ms per keyframe on the card (CUDA events, after a "
        f"warm-up at {runs[0]:.4f}); volume {nbytes} bytes; mesh {len(verts)} vertices {len(faces)} faces; "
        f"fly_through 8 frames {h}x{w_}x3 uint8, lit pixels {lit}: ok")
    return dict(ms=runs[1], flipped=flipped, voxels=int(t.size), bytes=nbytes)


def error_budget_rows(dev, card: str) -> dict:
    """Phase 11(c): the A and C rows over docs/error_budget_r05.json's orbit."""
    from sage_slam_tpu_torch.eval import error_budget
    from sage_slam_tpu_torch.ops import photo_reduce as pr

    with open(os.path.join(ROOT, ERROR_BUDGET_JAX)) as f:
        jax_rows = json.load(f)
    out = os.path.join(ROOT, "_runs", "error_budget.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    pr.photo_reduce.launches = 0
    t0 = time.perf_counter()
    report, systems = error_budget.run(["--num_frames", "64", "--stages", ",".join(ERROR_BUDGET_STAGES),
                                        "--out", out])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = pr.photo_reduce.launches
    iters = sum(s.mapper.step_iters_total for s in systems.values())
    for label in ERROR_BUDGET_STAGES:
        r, j = report[label], jax_rows[label]
        say(f"error_budget [{card}] {label}: {r['frames']} frames, {r['keyframes']} keyframes, lost "
            f"{r['tracking_lost']}, {r['wall_s']} s; ate_sim3_pct {r['ate_sim3_pct']} (JAX's TPU run "
            f"{j['ate_sim3_pct']}), kf_ate_sim3_pct {r.get('kf_ate_sim3_pct')} (JAX {j['kf_ate_sim3_pct']}), "
            f"depth RMSE mean {r.get('depth_rmse_mean')} (JAX {j['depth_rmse_mean']}); mapping LM iterations "
            f"{systems[label].mapper.step_iters_total}")
        numbers = [v for k, v in r.items() if isinstance(v, float)]
        if not np.isfinite(numbers).all() or abs(r["keyframes"] - j["keyframes"]) > 3 or r["frames"] != j["frames"]:
            fail(f"error_budget {label}: non-finite values or keyframes {r['keyframes']} outside "
                 f"{j['keyframes']} +- 3: {r}")
    if launches == 0 or launches != iters:
        fail(f"error_budget: photo_reduce launched {launches} times for {iters} mapping LM iterations")
    say(f"error_budget: photo_reduce launches {launches} = mapping LM iterations over the stages; "
        f"{run_s:.3f} s: ok")
    del systems
    torch.cuda.empty_cache()
    return dict(launches=launches, rows={k: report[k] for k in ERROR_BUDGET_STAGES})


def gt_probe_path(dev, card: str, peaks) -> dict:
    """Phase 11(d): the probe from exact ground truth, grad_report held
    against a CPU clone, the walk, and K1 at the full graph."""
    from sage_slam_tpu_torch.config import SlamConfig
    from sage_slam_tpu_torch.eval import gt_probe
    from sage_slam_tpu_torch.io.dataset import Bowl3DInterface
    from sage_slam_tpu_torch.ops import photo_reduce as pr

    with open(os.path.join(ROOT, GT_PROBE_JAX)) as f:
        jax_probe = json.load(f)
    # gt_probe.main's configuration with GT_PROBE's flags
    n_frames, h, w, stride, back = (GT_PROBE[k] for k in ("num_frames", "height", "width", "stride", "back"))
    data = Bowl3DInterface(num_frames=n_frames, height=h, width=w, seed=0, orbit_radius=0.22, rot_amp=0.25,
                           mask_margin=6)
    cfg = SlamConfig(net_input_size=(h, w), net_output_size=(h // 2, w // 2),
                     max_keyframes=max(32, n_frames // stride + 2))
    pr.photo_reduce.launches = 0
    t0 = time.perf_counter()
    system, kf_ids, kf_ts = gt_probe.build_gt_map(cfg, data, stride, back, device=dev)
    cpu = system.clone("cpu")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    grad = gt_probe.grad_report(system)
    grad_s = time.perf_counter() - t0
    saved = pr.photo_reduce.launches  # the CPU clone's plain reduces are no launches
    ref = gt_probe.grad_report(cpu)
    pr.photo_reduce.launches = saved
    worst = max(abs(grad[lb][k] - v) / max(abs(v), 1e-30) for lb, row in ref.items() for k, v in row.items()
                if abs(v) > 1e-12)
    for lb, row in ref.items():
        for k, v in row.items():
            if abs(grad[lb][k] - v) > GT_PROBE_GRAD_RTOL * abs(v) + 1e-12:
                fail(f"gt_probe grad_report {lb} {k}: card {grad[lb][k]!r}, CPU {v!r}")
    say(f"gt_probe [{card}]: {len(kf_ids)} keyframes at exact ground truth ({build_s:.3f} s); grad_report "
        f"({len(grad)} term subsets, {grad_s:.3f} s) card vs CPU clone: worst relative difference "
        f"{worst:.3g} (limit {GT_PROBE_GRAD_RTOL}): ok; total error {grad['total']['error']:.6g} (JAX's TPU run "
        f"{jax_probe['grad_at_gt']['total']['error']:.6g}), grad trans RMS {grad['total']['grad_trans_rms']:.6g} "
        f"(JAX {jax_probe['grad_at_gt']['total']['grad_trans_rms']:.6g})")
    del cpu
    t0 = time.perf_counter()
    sections = gt_probe.section_report(system, len(kf_ids) // 2, steps=GT_PROBE_SECTION_STEPS)
    section_s = time.perf_counter() - t0
    off = {k: v["argmin_frac"] for k, v in sections.items() if v["argmin_frac"] != 0.0}
    t0 = time.perf_counter()
    walk = gt_probe.walk_report(system, data, kf_ts)
    torch.cuda.synchronize()
    walk_s = time.perf_counter() - t0
    launches = pr.photo_reduce.launches
    iters = system.mapper.step_iters_total
    jw = jax_probe["walk_from_gt"]
    say(f"gt_probe [{card}]: sections at {GT_PROBE_SECTION_STEPS} steps over keyframe {len(kf_ids) // 2} "
        f"({section_s:.3f} s), argmins off zero: {off or 'none'}; walk {walk_s:.3f} s: keyframe Sim3-ATE "
        f"{walk['kf_ate_sim3_pct']}% of the span {walk['span']} (JAX's TPU run {jw['kf_ate_sim3_pct']}%), "
        f"scale spread {walk['scale_rel_spread_pct']}% (JAX {jw['scale_rel_spread_pct']}%), code max "
        f"{walk['code_norm_max']}; mapping LM iterations {iters}, photo_reduce launches {launches} "
        f"(= {len(grad)} grad_report linearizations + the walk's LM iterations)")
    if not np.isfinite([walk["kf_ate_sim3"], walk["scale_min"], walk["scale_max"]]).all():
        fail(f"gt_probe: non-finite walk {walk}")
    if launches != len(grad) + iters or iters == 0:
        fail(f"gt_probe: photo_reduce launched {launches} times for {len(grad)} linearizations and {iters} "
             f"mapping LM iterations")
    k1 = reduce_at_path_shape(system.mapper, cfg, system.cam_pyr, card, peaks, "gt_probe full-graph",
                              window_lo=0)
    del system
    torch.cuda.empty_cache()
    return dict(launches=launches, walk=walk, **k1)


def eval_path(dev, card: str, peaks) -> dict:
    """Phase 11: dense and diagnostic eval on the card (see the module note)."""
    from sage_slam_tpu_torch.demo import make_eval

    chain = make_eval_chain(dev, card)
    system = chain["system"]
    k1 = reduce_at_path_shape(system.mapper, system.cfg, system.cam_pyr, card, peaks, "make_eval demo")
    _, _, kf = make_eval.evaluate(chain["run_dir"], make_eval.eval_orbit(64))
    del system, chain["system"]
    torch.cuda.empty_cache()
    volume = tsdf_hold(kf, dev, card)
    budget = error_budget_rows(dev, card)
    probe = gt_probe_path(dev, card, peaks)
    return dict(launches={"make_eval": chain["launches"], "error_budget": budget["launches"],
                          "gt_probe": probe["launches"]},
                max_abs_err=max(k1["max_abs_err"], probe["max_abs_err"]),
                max_rel_err=max(k1["max_rel_err"], probe["max_rel_err"]),
                make_eval_shape=k1["shape"], gt_probe_shape=probe["shape"], tsdf=volume)


# phase 12: the default-off paths and multi-device BA. Tolerances: Schur
# test_schur_solver_matches_dense's (translations and codes at 48
# keyframes to ATOL_48); the mesh step
# test_mapping_step_sharded_matches_single_on_looped_map's; the two ranks
# tests/test_sharded_ba.py:41-52's and tests/test_sharded_store.py:64-81's.
MESH_RUN_DIR = "_runs/multi"
# the 48-keyframe ring (E=96+96) is anchored at keyframe 0 only, and its
# translations are ~1e-2: there test_schur_solver_matches_dense's atol
# 1e-6 (with rtol 1e-4) failed on an H100 80GB HBM3 at 700 W, 14 of 144
# translations off by up to 3.79e-6, while the error agreed to 5.4e-6
# relative; they are held to atol 1e-5, as tests/test_torch_schur.py
# holds its 48-keyframe chain (test_sharded_ba.py's translation atol)
ITERS_48 = 10
ATOL_48 = 1e-5


def stopwatch(fn):
    """fn() -> (its result, host ms), the card synchronized around it."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def rank_calls(mesh, *calls):
    """A rank body (parallel/launch.spawn) that runs several rank bodies
    (fn, jobs) in turn on one group -> per body its results, each with
    the host ms of its call (sharding included)."""
    out = []
    for fn, jobs in calls:
        res, ms = stopwatch(lambda fn=fn, jobs=jobs: fn(mesh, *jobs))
        out.append([dict(r, ms=ms) for r in res])
    return out


def counted(fn):
    """fn() -> (its result, K1's launches during it, host ms)."""
    from sage_slam_tpu_torch.ops import photo_reduce as pr

    torch.cuda.synchronize()
    pr.photo_reduce.launches = 0
    out, ms = stopwatch(fn)
    return out, pr.photo_reduce.launches, ms


def vars_diff(a, b, rows=None) -> dict:
    """max |a - b| per variable class, on the host (rows: a selection)."""
    sel = slice(None) if rows is None else rows
    return {name: float((x[sel].detach().cpu() - y[sel].detach().cpu()).abs().max())
            for name, x, y in (("trans", a.pose.trans, b.pose.trans), ("rot", a.pose.rot, b.pose.rot),
                               ("code", a.code, b.code), ("scale", a.scale, b.scale))}


def hold_run(out, ref, label: str, err_rtol: float, err_atol: float = 0.0, rtol: float = 0.0,
             atol: dict | None = None) -> str:
    """A run_ba-like result (variables, error, iterations, ...) against a
    reference: equal iterations, the error and each variable class to the
    tolerances given -> the printed differences."""
    (v, err, iters), (vr, err_r, iters_r) = out[:3], ref[:3]
    if iters != iters_r:
        fail(f"{label}: {iters} iterations against {iters_r}")
    np.testing.assert_allclose(float(err), float(err_r), rtol=err_rtol, atol=err_atol, err_msg=label)
    for name, a, b in (("trans", v.pose.trans, vr.pose.trans), ("rot", v.pose.rot, vr.pose.rot),
                       ("code", v.code, vr.code), ("scale", v.scale, vr.scale)):
        if atol is not None and name in atol:
            np.testing.assert_allclose(a.detach().cpu().numpy(), b.detach().cpu().numpy(), rtol=rtol,
                                       atol=atol[name], err_msg=f"{label} {name}")
    d = vars_diff(v, vr)
    return (f"{iters} iterations, error {float(err):.8g} vs {float(err_r):.8g}, max |d| "
            + ", ".join(f"{k} {x:.3g}" for k, x in d.items()))


def bench_prep(problem, variables, pyr, cfg, n_edges=None):
    """One linearization's K1 inputs on a prepared problem's photometric
    edges (the first n_edges of them)."""
    from sage_slam_tpu_torch.ops import photometric
    from sage_slam_tpu_torch.solver import ba

    pe = problem.photo_edges
    if n_edges is not None:
        pe = ba.EdgeTable(*(x[:n_edges] for x in pe))
    kf0, fr1, shared = ba._photo_inputs(problem.window, pe)
    return photometric.photo_prep(
        ba._edge_pose(variables, pe.i0), ba._edge_pose(variables, pe.i1),
        variables.code[pe.i0], variables.scale[pe.i0], kf0, fr1, shared, pyr, cfg.dpt_eps,
        soft=cfg.soft_inlier_gate,
    )


def prior_gap(mapper, full: bool) -> float:
    """What the full-capacity (mesh) problem's error holds beyond the
    compact step's from the same state: the priors of active keyframes
    outside the compact set, which are frozen, so a constant. The
    incident rows' terms cancel; the edge selection is the same."""
    from sage_slam_tpu_torch.solver import ba

    n, _, v = mapper.store.snapshot()
    lo = 0 if full else max(0, n - mapper.cfg.mapper.window_size)
    compact, v_c, _, _, _ = mapper._compact_step_inputs(n, v, full)
    whole = mapper.build_problem(window_lo=lo, num_active=n)
    dev = v.scale.device
    none = ba.EdgeTable(*(torch.zeros(0, dtype=t, device=dev)
                          for t in (torch.int64, torch.int64, torch.float32)))

    def priors_only(pb):
        return pb._replace(photo_edges=none, geo_edges=none, reproj_edges=None)

    cfg, pyr = mapper.cfg.mapper, mapper.cam_pyr
    return float(ba.total_error(v, priors_only(whole), pyr, cfg)
                 - ba.total_error(v_c, priors_only(compact), pyr, cfg))


def schur_path(dev, card: str) -> dict:
    """Phase 12(a): the Schur solver at the bench point, and "auto" at 48
    keyframes (see the module note)."""
    from sage_slam_tpu_torch import synthetic
    from sage_slam_tpu_torch.config import MapperConfig
    from sage_slam_tpu_torch.solver import ba, graph

    cfg = MapperConfig()
    variables, problem, pyr = synthetic.bench_problem(device=dev)
    k = variables.num_kf
    ones = torch.ones(k, device=dev)
    plain = ba.prepare_problem(problem, pyr)
    launches = {}
    out_p = ba.run_ba(variables, plain, pyr, cfg, ones, max_iters=10)
    # an error that descends to ~0 is held to 1e-7 of the start's beside
    # the relative tolerance (test_run_ba_matches_jax's atol)
    err0 = float(ba.linearize(variables, plain, pyr, cfg)[2])

    # Schur against dense at the bench point and at 48 keyframes
    schur_cfg, dense_cfg = (dataclasses.replace(cfg, solver=s) for s in ("schur", "dense"))
    out_s, launches["schur"], _ = counted(
        lambda: ba.run_ba(variables, plain, pyr, schur_cfg, ones, max_iters=10))
    if launches["schur"] != out_s[2]:
        fail(f"schur run_ba: K1 launched {launches['schur']} times for {out_s[2]} iterations")
    line = hold_run(out_s, out_p, "schur vs dense, bench point", 1e-5, 1e-7 * err0, rtol=1e-4,
                    atol={"trans": 1e-6, "code": 1e-6})
    say(f"schur: run_ba at the bench point (K={k}), schur vs dense: {line}: ok")
    v48, p48, pyr48 = synthetic.bench_problem(device=dev, k=48, n_photo=96, n_geo=96)
    p48 = ba.prepare_problem(p48, pyr48)
    ones48 = torch.ones(48, device=dev)
    seen = []
    lm_loop = graph.lm_loop

    def spy(*args, solver="dense", **kwargs):
        seen.append(solver)
        return lm_loop(*args, solver=solver, **kwargs)

    graph.lm_loop = spy
    try:
        auto_cfg = dataclasses.replace(cfg, solver="auto")
        out_a, n_auto, _ = counted(lambda: ba.run_ba(v48, p48, pyr48, auto_cfg, ones48,
                                                     max_iters=ITERS_48))
        out_d48 = ba.run_ba(v48, p48, pyr48, dense_cfg, ones48, max_iters=ITERS_48)
    finally:
        graph.lm_loop = lm_loop
    launches["schur"] += n_auto
    if seen != ["schur", "dense"] or n_auto != out_a[2]:
        fail(f"auto at 48 keyframes: solvers {seen}, K1 launches {n_auto} for {out_a[2]} iterations")
    err48 = float(ba.total_error(v48, p48, pyr48, cfg))
    line = hold_run(out_a, out_d48, "auto (schur) vs dense, 48 keyframes", 1e-5, 1e-7 * err48,
                    rtol=1e-4, atol={"trans": ATOL_48, "code": ATOL_48})
    say(f"schur: run_ba solver='auto' at 48 keyframes (E=96+96, {ITERS_48} iterations) took "
        f"{seen[0]}; vs dense: {line}: ok")
    for label, vv, pp, pyr_, ones_ in (("bench point K=8", variables, plain, pyr, ones),
                                       ("48 keyframes", v48, p48, pyr48, ones48)):
        t = {name: time_steps(lambda c=c: ba.run_ba(vv, pp, pyr_, c, ones_, max_iters=10))[:2]
             for name, c in (("dense", dense_cfg), ("schur", schur_cfg), ("dense", dense_cfg))}
        say(f"time [{card}] run_ba 10-iteration step at the {label}: "
            + ", ".join(f"{n} {h:.3f} ms host / {e:.3f} ms events" for n, (h, e) in t.items())
            + f" (system width {vv.num_kf * vv.block_dim})")
    return dict(launches=launches, bench=(variables, plain, pyr, cfg))


def multi_device(dev, card: str, peaks, mapper, bench) -> dict:
    """Phase 12(b-c): the mapper's step on a one-rank NCCL group, and
    two gloo ranks on the one card (see the module note)."""
    from sage_slam_tpu_torch import convert
    from sage_slam_tpu_torch.ops import photometric
    from sage_slam_tpu_torch.parallel import launch, sharded_ba, sharded_store
    from sage_slam_tpu_torch.solver import ba

    launches = {}
    run_dir = os.path.join(ROOT, MESH_RUN_DIR)
    os.makedirs(run_dir, exist_ok=True)
    cfg = mapper.cfg
    n = mapper.store.num_active
    width = mapper.store.capacity * (7 + cfg.code_size)
    w = cfg.mapper.photo_factor_weights
    coarse = tuple(0.0 if lvl < len(w) // 2 else w[lvl] for lvl in range(len(w)))
    k1_mesh = None
    with launch.one_rank(dev, backend="nccl", workdir=run_dir) as mesh:
        say(f"mesh: one-rank {torch.distributed.get_backend()} group on {mesh.device}, "
            f"the phase-6 mapper's state ({n} keyframes, store capacity {mapper.store.capacity}, "
            f"a {width}-wide system)")
        for label, kw in (("windowed", {}), ("refine's coarse weights", dict(full=True,
                                                                             photo_weights=coarse))):
            single, sharded = mapper.clone(dev), mapper.clone(dev)
            gap = prior_gap(mapper, kw.get("full", False))
            err_m, count, ms_m = counted(lambda: sharded.mapping_step(mesh=mesh, **kw))
            err_s, ms_s = stopwatch(lambda: single.mapping_step(**kw))
            launches[f"mesh {label}"] = count
            if count != sharded.last_step_iters or count == 0:
                fail(f"mesh step ({label}): K1 launched {count} times for "
                     f"{sharded.last_step_iters} iterations")
            if sharded.last_step_iters != single.last_step_iters:
                fail(f"mesh step ({label}): {sharded.last_step_iters} iterations against "
                     f"{single.last_step_iters}")
            # the full-capacity error holds the frozen keyframes' priors
            # that the compact step leaves out: a constant
            np.testing.assert_allclose(err_m - gap, err_s, rtol=1e-4, err_msg=label)
            d = vars_diff(sharded.store.variables, single.store.variables, slice(0, n))
            if max(d.values()) > 1e-5:
                fail(f"mesh step ({label}) vs unsharded: {d}")
            if sharded.photo_edge_iters != single.photo_edge_iters:
                fail(f"mesh step ({label}): edge budgets differ from the unsharded step's")
            say(f"mesh step ({label}) vs unsharded from the same state: {count} iterations, "
                f"error {err_m:.8g} less the frozen keyframes' priors {gap:.6g} vs {err_s:.8g}, max |d| "
                + ", ".join(f"{k_} {x:.3g}" for k_, x in d.items())
                + f": ok; [{card}] first call: sharded {ms_m:.3f} ms ({width}-wide system), "
                f"unsharded {ms_s:.3f} ms (compact system)")
            if k1_mesh is None:
                k1_mesh = reduce_at_path_shape(sharded, cfg, mapper.cam_pyr, card, peaks, "mesh")
                # a second step on each clone, warm: same shapes, state moved on
                t_m = stopwatch(lambda: sharded.mapping_step(mesh=mesh))[1]
                t_s = stopwatch(lambda: single.mapping_step())[1]
                say(f"time [{card}] mesh mapping_step, second call: sharded {t_m:.3f} ms "
                    f"({sharded.last_step_iters} iterations, {width}-wide), unsharded {t_s:.3f} ms "
                    f"({single.last_step_iters} iterations)")
            del single, sharded
            torch.cuda.empty_cache()

    # (d) two gloo ranks on the card, against one process
    variables, problem, pyr, bcfg = bench
    v_cpu, p_cpu = convert.to_device(variables, "cpu"), convert.to_device(problem, "cpu")
    k = variables.num_kf
    ids = torch.arange(k)
    umask = torch.ones(k)
    umask[0] = 0.0  # one frozen row
    ba_job = (v_cpu, p_cpu, pyr, bcfg, torch.ones(k), 10, False)
    store_job = (v_cpu, p_cpu.window, p_cpu.photo_edges, p_cpu.geo_edges, None, p_cpu.priors, ids,
                 torch.ones(k), umask, pyr, bcfg, 10)
    (outs, ms_spawn) = stopwatch(lambda: launch.spawn(
        rank_calls, 2, [(sharded_ba.run_rank, [ba_job]), (sharded_store.run_rank, [store_job])],
        devices=["cuda:0", "cuda:0"], backend="gloo", workdir=os.path.join(run_dir, "gloo"),
        timeout_s=400))
    ref = ba.run_ba(variables, problem, pyr, bcfg, torch.ones(k, device=dev), max_iters=10)
    ids_d = ids.to(dev)
    compact = ba.compact_problem_keyframes(problem, ids_d, torch.ones(k, device=dev), pyr)
    ref_c = ba.run_ba(variables, compact, pyr, bcfg, umask.to(dev), max_iters=10)
    launches["gloo ranks"] = 0
    as_vars = lambda o: type(variables)(type(variables.pose)(o["rot"], o["trans"]), o["code"],  # noqa: E731
                                        o["scale"])
    for name, which, refv, err_tol, tol in (
            ("sharded_run_ba", 0, ref, (1e-4, 1e-6), dict(trans=1e-5, code=1e-5)),
            ("sharded_window_run_ba", 1, ref_c, (5e-4, 1e-6), dict(trans=1e-6, scale=1e-6))):
        rank_outs = [o[which][0] for o in outs]
        for rank, o in enumerate(rank_outs):
            label = f"{name} rank {rank}"
            rtol = 1e-4 if which == 1 else 0.0
            line = hold_run((as_vars(o), o["error"], o["iterations"]), refv, label, err_tol[0],
                            err_tol[1], rtol=rtol, atol=tol)
            if o["launches"] != o["iterations"]:
                fail(f"{label}: K1 launched {o['launches']} times for {o['iterations']} iterations")
            for key in ("rot", "trans", "code", "scale", "error"):
                if not torch.equal(o[key], rank_outs[0][key]):
                    fail(f"{name}: rank {rank}'s {key} differs from rank 0's")
            extra = (f", photometric edges {o['photo_edges']}" if which == 0 else
                     f", store tables {o['local_bytes']} bytes on this rank (store_bytes_per_device "
                     f"{o['accounting']})")
            say(f"gloo: {label} on the card vs one process: {line}; K1 launches {o['launches']}, "
                f"{o['ms']:.3f} ms{extra}: ok")
            launches["gloo ranks"] += o["launches"]
        say(f"gloo: {name}: the two ranks' variables and error are bit-equal: ok")
    say(f"gloo: two ranks on {card} took {ms_spawn / 1e3:.2f} s from spawn to join")
    k1_rank = k1_hold(bench_prep(problem, variables, pyr, bcfg, problem.photo_edges.i0.shape[0] // 2),
                      tuple(bcfg.photo_factor_weights), photometric.level_ratios(pyr), card, peaks,
                      "one rank's prep inputs (E=12 of 24)")
    return dict(launches=launches, k1_mesh=k1_mesh, k1_rank=k1_rank)


def extras_path(dev, card: str, peaks, mapper) -> dict:
    """Phase 12: the default-off paths and multi-device BA."""
    t0 = time.perf_counter()
    a = schur_path(dev, card)
    bc = multi_device(dev, card, peaks, mapper, a["bench"])
    secs = time.perf_counter() - t0
    say(f"phase 12 took {secs:.1f} s")
    k1s = (bc["k1_mesh"], bc["k1_rank"])
    return dict(launches={**a["launches"], **bc["launches"]},
                max_abs_err=max(k["max_abs_err"] for k in k1s),
                max_rel_err=max(k["max_rel_err"] for k in k1s),
                mesh_shape=bc["k1_mesh"]["shape"],
                rank_shape=bc["k1_rank"]["shape"], seconds=secs)


# phase 13: the port's measuring programs (sage_slam_tpu_torch/bench/,
# entry.py) at their JAX programs' operating points. The metric names each
# must print (bench.py, bench_frontend.py, bench_scaling.py) and the keys
# of bench_roofline.py's object
PROGRAM_METRICS = {
    "global_ba": {"factors_per_second_global_ba_1iter", "factors_per_second_global_ba"},
    "frontend": {"frontend_ms_per_frame", "frontend_build_frame_ms", "frontend_keyframe_overhead_ms",
                 "frontend_fps", "frontend_whole_run_fps"},
    "scaling": {"factors_per_second_sharded_ba", "mapping_step_ms"},
}
ROOFLINE_KEYS = {
    "backend", "stream_GBps_rw", "matmul_f32_TFLOPs", "gather_ns_per_row", "gather_effective_GBps",
    "factors_per_second_10iter", "factors_per_second_1iter", "ba_step_ms_10iter", "ba_iter_ms",
    "model_gather_MB_per_iter", "model_reduce_GFLOP_per_iter", "sol_streaming_ms", "sol_gather_wall_ms",
    "sol_mxu_ms", "pct_of_gather_wall", "pct_of_streaming_roofline", "mfu_pct",
}


def finite_numbers(record: dict, label: str) -> None:
    for key, value in record.items():
        if isinstance(value, (int, float)) and not isinstance(value, bool) and not np.isfinite(value):
            fail(f"{label}: {key} = {value} is not finite")


def program_run(name: str, main, argv: list, card: str) -> tuple:
    """One program's main(argv) in this process, its output echoed ->
    (what main returned, its JSON lines, K1's launches in this process,
    seconds). The first line must name this card."""
    import contextlib
    import io

    from sage_slam_tpu_torch.ops import photo_reduce as pr

    buf = io.StringIO()
    pr.photo_reduce.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = main(argv)
    secs = time.perf_counter() - t0
    launches = pr.photo_reduce.launches
    text = buf.getvalue()
    for line in text.splitlines():
        say(f"  {name} {' '.join(argv)}: {line}")
    lines = [json.loads(line) for line in text.splitlines() if line.startswith("{")]
    if not lines or lines[0].get("card") != card:
        fail(f"{name}: the first line does not name the card {card!r}: {lines[:1]}")
    for rec in lines[1:]:
        finite_numbers(rec, name)
    return out, lines[1:], launches, secs


def programs_k1(dev, card: str, peaks) -> dict:
    """K1 held and timed on the prep inputs of the programs' shapes beyond
    the bench point: scaling's rank problem (each rank's block is its
    contiguous share of the edges) and growth_curve's largest full step."""
    from sage_slam_tpu_torch import synthetic
    from sage_slam_tpu_torch.bench import scaling
    from sage_slam_tpu_torch.config import MapperConfig
    from sage_slam_tpu_torch.ops import photometric
    from sage_slam_tpu_torch.solver import ba

    cfg = MapperConfig()
    weights = tuple(cfg.photo_factor_weights)
    variables, problem, pyr = synthetic.bench_problem(device=dev, n=scaling.SAMPLES,
                                                      n_photo=scaling.EDGES_PER_TYPE,
                                                      n_geo=scaling.EDGES_PER_TYPE)
    problem = ba.prepare_problem(problem, pyr)
    holds = {}
    for ranks in (1, 2):
        prep = bench_prep(problem, variables, pyr, cfg, scaling.EDGES_PER_TYPE // ranks)
        holds[f"scaling_{ranks}_rank"] = k1_hold(prep, weights, photometric.level_ratios(pyr), card, peaks,
                                                 f"scaling's rank problem on {ranks} rank(s)")
    del variables, problem, prep
    for g in scaling.growth_points(dev):
        pass  # the last graph, drawn after the others as growth_curve draws it
    prep = bench_prep(ba.prepare_problem(g.problems["full"], g.cam_pyr), g.variables, g.cam_pyr, cfg)
    holds["growth_full"] = k1_hold(prep, weights, photometric.level_ratios(g.cam_pyr), card, peaks,
                                   f"growth_curve's full step at {g.keyframes} keyframes")
    return holds


def programs_path(dev, card: str, peaks) -> dict:
    """Phase 13: every measuring program of the port on the card (see the
    module note) -> K1's launches by program, and K1 at their shapes."""
    from sage_slam_tpu_torch import entry
    from sage_slam_tpu_torch.bench import frontend, global_ba, roofline, scaling

    t0 = time.perf_counter()
    launches = {}

    def hold_launches(label: str, n: int, want: int) -> None:
        if n != want:
            fail(f"{label}: K1 launched {n} times for {want} LM iterations")

    (step, ranks), _, n, secs = program_run("entry", entry.main, [], card)
    if step[2] < 1 or not bool(torch.isfinite(step[1])):
        fail(f"entry(): iterations {step[2]}, error {step[1]}")
    for res in (*ranks[0], *ranks[1]):
        if (not np.isfinite(res["error"]) or res["iterations"] != 2
                or (res["device"], res["backend"]) != ("cuda:0", "nccl")):
            fail(f"dryrun_multichip(1): {res}")
    # the dryruns' ranks are processes of their own: their launches are not this process's
    hold_launches("entry", n, step[2])
    launches["entry"] = n
    say(f"programs: entry: entry()'s step ({step[2]} LM iteration) and dryrun_multichip(1) on cuda:0 "
        f"under NCCL (errors {ranks[0][0]['error']:.8g}, {ranks[1][0]['error']:.8g}) in {secs:.2f} s; "
        f"K1 launches {n}: ok")

    for name, main in (("global_ba", global_ba.main), ("frontend", frontend.main)):
        out, lines, n, secs = program_run(name, main, [], card)
        names = {r["metric"] for r in lines}
        # frontend_keyframe_overhead_ms is printed only when a keyframe was made
        if not PROGRAM_METRICS[name] - {"frontend_keyframe_overhead_ms"} <= names <= PROGRAM_METRICS[name]:
            fail(f"{name}: metrics {sorted(names)}, expected {sorted(PROGRAM_METRICS[name])}")
        # the frontend runs no BA step
        hold_launches(name, n, sum(r["lm_iterations"] for r in out) if name == "global_ba" else 0)
        launches[name] = n
        say(f"programs: {name}: {len(lines)} metric lines in {secs:.2f} s; K1 launches {n}: ok")

    out, lines, n, secs = program_run("roofline", roofline.main, [], card)
    printed = {k: v for k, v in out.items() if k != "lm_iterations"}
    if not ROOFLINE_KEYS <= set(printed) or lines != [printed]:
        fail(f"roofline: keys {sorted(printed)} (expected {sorted(ROOFLINE_KEYS)})")
    hold_launches("roofline", n, out["lm_iterations"])
    launches["roofline"] = n
    say(f"programs: roofline in {secs:.2f} s; K1 launches {n}: ok")

    holds = programs_k1(dev, card, peaks)
    # the flush's check again, late in the script, after the other paths' work
    probe = flush_probe(peaks[0], card)

    # one NCCL rank (the one card) with growth_curve up to 128 keyframes,
    # then two gloo ranks on the one card without it
    for label, argv, sizes in (("scaling", [], [1]),
                               ("scaling, two gloo ranks", ["--device", "cuda:0", "--ranks", "2",
                                                            "--growth-max", "0"], [1, 2])):
        out, lines, n, secs = program_run("scaling", scaling.main, argv, card)
        names = {r["metric"] for r in lines}
        want = PROGRAM_METRICS["scaling"] - (set() if out["growth"] else {"mapping_step_ms"})
        if names != want or [r["devices"] for r in out["scaling"]] != sizes:
            fail(f"{label}: metrics {sorted(names)} over meshes {[r['devices'] for r in out['scaling']]}")
        rank_runs = [x for r in out["scaling"] for x in r["ranks"]]
        for x in rank_runs:
            hold_launches(f"{label}, a rank", x["launches"], x["lm_iterations"])
        # the ranks are processes of their own: this process ran growth_curve only
        hold_launches(f"{label}, growth_curve", n, sum(r["lm_iterations"] for r in out["growth"]))
        if out["growth"] and [r["keyframes"] for r in out["growth"]] != [8, 16, 32, 64, 128]:
            fail(f"growth_curve: keyframe counts {[r['keyframes'] for r in out['growth']]}")
        rank_launches = sum(x["launches"] for x in rank_runs)
        launches[label] = rank_launches + n
        say(f"programs: {label} in {secs:.2f} s; K1 launches {rank_launches} on the ranks, {n} by "
            "growth_curve: ok")

    secs = time.perf_counter() - t0
    say(f"phase 13 took {secs:.1f} s")
    return dict(launches=launches, seconds=secs, probe=probe, shapes={k: h["shape"] for k, h in holds.items()},
                max_abs_err=max(h["max_abs_err"] for h in holds.values()),
                max_rel_err=max(h["max_rel_err"] for h in holds.values()))


# ---- 14. the prep kernel (ops/photo_prep, csrc/photo_prep.cu) ----

# Tolerances of the prep kernel against the plain chain (photometric.
# photo_prep) on the same inputs. The two compute the warp's coordinates
# from sums in different orders: the 16-term code . jac dot product and the
# 3x3 products are cuBLAS batched products in the plain chain and FMA chains
# in the kernel, a few float32 roundings apart, so a coordinate moves by a
# few ulps of itself (~2e-5 px at 80 px). A sample moves by its bilinear
# slope times that, at most twice its block's largest value a pixel, and the
# coarse levels' hat-weight matmuls round their sums in another order
# again (~1e-6 of the values). The K-rows are the same formulas in other
# roundings, but some cancel: the depth, code and scale rows are
# fx (rh_x / z - x rh_z / z^2) times a factor, two terms that nearly cancel
# on a short baseline, so their float32 error is relative to the terms,
# not to the row (up to 2e-4 of the row's max in the cell). Each K-row is
# therefore held to the plain chain's own accuracy: both against the plain
# chain evaluated in float64 on the same inputs, the kernel's largest error
# in a row within PREP_KROW_FACTOR of the plain chain's (or of 1e-7 of the
# row's max, where that is larger): the largest such ratio over the 10,788
# rows of the cell's problem read 2.52 on the card, while a wrong term
# reads errors of the order of the row itself, a thousand times the plain
# chain's. The source features are a copy and must be bit-equal.
PREP_FGS_ATOL = 2e-4  # of max |sample| over one edge's level block
PREP_KROW_FACTOR = 8.0
PREP_KROW_FLOOR = 1e-7  # of max |value| over one edge's K-row
PREP_GATE_ATOL = 1e-4  # the soft gate: a bilinear of a 0/1 mask, slope <= 1 a pixel
# the hard gate (nearest pixel, half up) and the z > eps test are steps: a
# point within this distance of a step may fall either side
PREP_STEP_PX = 1e-3
PREP_STEP_Z = 1e-5
# K1 on the kernel's prep against K1 on the plain chain's (phase 4's
# linearize tolerance), on edges without a point at a step
PREP_K1_RTOL, PREP_K1_ATOL = 1e-4, 1e-5  # atol of max |ata|


def prep_bound(prep, problem, e_sel, peak_bw: float):
    """The prep kernel's least time for these edges: its outputs written
    once, and once each the source rows of the distinct source keyframes
    (homo, the depth decode, the source features) and the pixel table of
    the distinct target frames, at the memory rate -> (ms, bytes)."""
    w = problem.window
    out_b = sum(t.numel() * t.element_size() for t in prep)
    i0, i1 = (x[e_sel] for x in (problem.photo_edges.i0, problem.photo_edges.i1))
    k = w.loc1d.shape[0]
    t = w.tables
    src_row = (w.homo.numel() + t.bias_at.numel() + t.jac_at.numel() + w.src_feats.numel()) * 4 // k
    frame = t.pixel_fg.numel() * 4 // k
    nbytes = out_b + len(set(i0.tolist())) * src_row + len(set(i1.tolist())) * frame
    return nbytes / peak_bw * 1e3, nbytes


def _plain_prep(variables, window, pe, pyr, cfg, soft):
    from sage_slam_tpu_torch.ops import photometric
    from sage_slam_tpu_torch.solver import ba

    kf0, fr1, shared = ba._photo_inputs(window, pe)
    return photometric.photo_prep(
        ba._edge_pose(variables, pe.i0), ba._edge_pose(variables, pe.i1), variables.code[pe.i0],
        variables.scale[pe.i0], kf0, fr1, shared, pyr, cfg.dpt_eps, soft=soft)


def _double(tree):
    """A (nested) NamedTuple or tuple with its float32 tensors in float64."""
    if isinstance(tree, torch.Tensor):
        return tree.double() if tree.dtype == torch.float32 else tree
    if isinstance(tree, tuple):
        items = [_double(x) for x in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return tree


def _near_steps(variables, window, pe, pyr, cfg):
    """[E, N]: points whose plain level-0 coordinate lies within
    PREP_STEP_PX of the nearest rule's step (a half pixel) or whose z lies
    within PREP_STEP_Z of eps, relative."""
    from sage_slam_tpu_torch.ops import photometric
    from sage_slam_tpu_torch.solver import ba

    kf0, _, shared = ba._photo_inputs(window, pe)
    out = photometric._warp_project_cm(
        ba._edge_pose(variables, pe.i0), ba._edge_pose(variables, pe.i1), variables.code[pe.i0],
        variables.scale[pe.i0], kf0, shared, pyr[0], cfg.dpt_eps)
    x1, u1, v1 = out[4], out[6], out[7]
    near = torch.zeros_like(u1, dtype=torch.bool)
    for c in ((u1 + 0.5) - 0.5, (v1 + 0.5) - 0.5):
        near |= ((c - torch.floor(c)) - 0.5).abs() < PREP_STEP_PX
    near |= (x1[:, 2] - cfg.dpt_eps).abs() < PREP_STEP_Z * cfg.dpt_eps
    return near


def _block_excess(got, ref, atol_share, dims):
    """Elements of |got - ref| over atol_share x max |ref| of their block
    (max over ``dims``), NaN positions apart -> (excess mask, largest
    |d| / block max, NaN positions differ)."""
    nan_g, nan_r = torch.isnan(got), torch.isnan(ref)
    g, r = got.nan_to_num(0.0).double(), ref.nan_to_num(0.0).double()
    scale = r.abs().amax(dim=dims, keepdim=True).clamp(min=1e-30)
    rel = (g - r).abs() / scale
    return rel > atol_share, float(rel.max()), bool((nan_g != nan_r).any())


def prep_compare(variables, window, pe, pyr, cfg, soft, label):
    """The kernel's five outputs against the plain chain's, element by
    element, then K1 on each -> (stats, faults)."""
    from sage_slam_tpu_torch.ops import photo_prep as pp
    from sage_slam_tpu_torch.ops import photo_reduce as pr
    from sage_slam_tpu_torch.ops import photometric
    from sage_slam_tpu_torch.solver import ba

    before = pp.photo_prep_edges.launches
    got = ba._photo_prep(variables, window, pe, pyr, cfg.dpt_eps, soft)
    ref = _plain_prep(variables, window, pe, pyr, cfg, soft)
    torch.cuda.synchronize()
    faults = []
    if pp.photo_prep_edges.launches != before + 1:
        faults.append("the dispatch did not launch the kernel")
    fgs, f0, gate, kx, ky = got
    fgs_r, f0_r, gate_r, kx_r, ky_r = ref
    if not torch.equal(f0, f0_r):
        faults.append("f0_cm is not bit-equal")
    near = _near_steps(variables, window, pe, pyr, cfg)
    stats = dict(points=int(gate.numel()), near_steps=int(near.sum()))
    # fgs per (edge, level, channel block of f1 | gx | gy)
    e, lv, c3, n = fgs.shape
    blocks = lambda t: t.reshape(e, lv, 3, c3 // 3, n)  # noqa: E731
    over, stats["fgs"], nan_diff = _block_excess(blocks(fgs), blocks(fgs_r), PREP_FGS_ATOL, (3, 4))
    if nan_diff or bool(over.any()):
        faults.append(f"fgs: {int(over.sum())} elements over {PREP_FGS_ATOL} of their block's max "
                      f"(largest {stats['fgs']:.3g}), NaN positions differ: {nan_diff}")
    exact = _plain_prep(_double(variables), _double(window), pe, pyr, cfg, soft)
    for name, a, b, t in (("kx", kx, kx_r, exact[3]), ("ky", ky, ky_r, exact[4])):
        nan_diff = bool((torch.isnan(a) != torch.isnan(b)).any())
        t = t.nan_to_num(0.0)
        err_k = (a.double().nan_to_num(0.0) - t).abs().amax(dim=2)  # [E, dim]
        err_p = (b.double().nan_to_num(0.0) - t).abs().amax(dim=2)
        ratio = err_k / torch.maximum(err_p, PREP_KROW_FLOOR * t.abs().amax(dim=2)).clamp(min=1e-300)
        stats[name] = float(ratio.max())
        stats[name + "_plain"] = float((err_p / t.abs().amax(dim=2).clamp(min=1e-300)).max())
        if nan_diff or bool((ratio > PREP_KROW_FACTOR).any()):
            faults.append(f"{name}: {int((ratio > PREP_KROW_FACTOR).sum())} rows whose error against "
                          f"float64 is over {PREP_KROW_FACTOR}x the plain chain's (largest "
                          f"{stats[name]:.3g}x), NaN positions differ: {nan_diff}")
    del exact
    dg = (gate.nan_to_num(0.0) - gate_r.nan_to_num(0.0)).abs()
    gate_nan = bool((torch.isnan(gate) != torch.isnan(gate_r)).any())
    off = (dg > (PREP_GATE_ATOL if soft else 0.0))
    stats["gate"] = float(dg.max())
    stats["gate_steps"] = int((off & near).sum())
    if gate_nan or bool((off & ~near).any()):
        faults.append(f"gate: {int((off & ~near).sum())} points differ away from a step "
                      f"(largest {stats['gate']:.3g}), NaN positions differ: {gate_nan}")
    # K1 on each prep, on the edges without a point at a step
    ratios, weights = photometric.level_ratios(pyr), tuple(cfg.photo_factor_weights)
    saved = pr.photo_reduce.launches
    k1 = [tuple(x.clone() for x in pr.photo_reduce(*p, weights, ratios)) for p in (got, ref)]
    pr.photo_reduce.launches = saved
    keep = ~(off & near).any(dim=1)
    stats["k1_edges"] = int(keep.sum())
    scale = float(k1[1][0][keep].double().nan_to_num(0.0).abs().max().clamp(min=1e-30))
    for name, a, b in zip(("ata", "atb", "err", "n_inl"), k1[0], k1[1]):
        a, b = a[keep].double(), b[keep].double()
        atol = PREP_K1_ATOL * scale if name in ("ata", "atb") else 0.0
        bad = ~torch.isclose(a, b, rtol=PREP_K1_RTOL, atol=atol, equal_nan=True)
        # |d| over max |ata| for ata and atb, over |value| for err and n_inl
        d = (a - b).nan_to_num(0.0).abs() / (scale if atol else b.nan_to_num(0.0).abs().clamp(min=1e-30))
        stats[f"k1_{name}"] = float(d.max()) if d.numel() else 0.0
        if bool(bad.any()):
            faults.append(f"K1 {name}: {int(bad.sum())} entries outside rtol {PREP_K1_RTOL}"
                          f"{f' + atol {PREP_K1_ATOL} max|ata|' if atol else ''}")
    say(f"prep kernel vs plain: {label} {'soft' if soft else 'hard'} gate E={e} N={n}: largest |d| / "
        f"block max fgs {stats['fgs']:.3g}; K-rows' error against float64 over the plain chain's: kx "
        f"{stats['kx']:.3g}x, ky {stats['ky']:.3g}x (the plain chain's: {stats['kx_plain']:.3g}, "
        f"{stats['ky_plain']:.3g} of the row's max); gate "
        f"{stats['gate']:.3g} ({stats['gate_steps']} at a step of {stats['near_steps']} near one); K1 on "
        f"{stats['k1_edges']} edges, |d| over max |ata|: ata {stats['k1_ata']:.3g}, atb "
        f"{stats['k1_atb']:.3g}; relative: err {stats['k1_err']:.3g}, n_inl {stats['k1_n_inl']:.3g}; "
        f"{'ok' if not faults else 'FAULTS: ' + '; '.join(faults)}")
    return stats, faults


def prep_variants(variables, window, seed: int):
    """(label, variables, window): codes and scales drawn about the given
    ones with the prepared decode tables (bias_at, jac_at) and without them
    (the bias_flat[loc] path), and with keyframe 1 turned half a turn about
    y (its points behind the cameras), keyframe 2 moved 50 units along x
    (outside every image) and keyframe 3's scale NaN (NaN coordinates)."""
    from sage_slam_tpu_torch.geometry.se3 import SE3
    from sage_slam_tpu_torch.solver.graph import Variables

    dev = variables.scale.device
    g = torch.Generator().manual_seed(seed)
    k, cs = variables.code.shape
    code = variables.code + 0.1 * torch.randn((k, cs), generator=g).to(dev)
    scale = variables.scale * (1.0 + 0.1 * torch.randn(k, generator=g)).to(dev)
    v = Variables(variables.pose, code, scale)
    rot, trans, scale_f = variables.pose.rot.clone(), variables.pose.trans.clone(), scale.clone()
    rot[1] = rot[1] @ torch.diag(torch.tensor([-1.0, 1.0, -1.0], device=dev))
    trans[2, 0] += 50.0
    scale_f[3] = float("nan")
    faulty = Variables(SE3(rot, trans), code, scale_f)
    flat = window._replace(tables=window.tables._replace(bias_at=None, jac_at=None))
    return [("decode tables", v, window), ("bias_flat[loc]", v, flat),
            ("behind, outside, NaN", faulty, window)]


def cell_problem(dev, keyframes: int = 64, connections: int = 3, code_size: int = 16):
    """The benchmark cell's problem (refine_map64.full_graph_lm, or
    refine_map64_cs32's at code_size=32): a map of ``keyframes`` keyframes
    built through the mapper at SlamConfig()'s widths with a
    ``code_size``-dim code (random networks, synthetic.mapper_scene), each
    with photometric and geometric factors both ways to its
    ``connections`` predecessors, and the compact problem
    mapping_step(full=True) solves -> (variables, prepared problem, update
    mask, pyramid, config)."""
    from sage_slam_tpu_torch import synthetic
    from sage_slam_tpu_torch.config import SlamConfig
    from sage_slam_tpu_torch.geometry.camera import CameraPyramid
    from sage_slam_tpu_torch.geometry.se3 import SE3
    from sage_slam_tpu_torch.mapping.mapper import Mapper
    from sage_slam_tpu_torch.models import depth_network, feature_network
    from sage_slam_tpu_torch.solver import ba

    cfg = SlamConfig(code_size=code_size)
    scene = synthetic.mapper_scene(keyframes, seed=0, height=cfg.net_input_size[0],
                                   width=cfg.net_input_size[1])
    pyr = CameraPyramid.build(scene.camera, cfg.pyramid_levels)
    gen = torch.Generator().manual_seed(0)
    dnet = depth_network.init_network(
        gen, depth_network.DepthNetConfig(basis_inner=((128, 128, cfg.code_size),)))
    fnet = feature_network.init_network(gen, feature_network.FeatureNetConfig())
    mapper = Mapper(cfg, pyr, scene.mask_out, dnet, fnet, video_mask_in=scene.mask_in, device=dev)
    images = torch.from_numpy(scene.images).to(dev)
    mapper.init_one_frame(0.0, images[0])
    for f in range(1, keyframes):
        pose = SE3(torch.from_numpy(scene.rot[f]).to(dev), torch.from_numpy(scene.trans[f]).to(dev))
        fr = mapper.build_frame(0.1 * f, images[f], pose=pose)
        n = mapper.store.num_active
        mapper.enqueue_keyframe(fr, list(range(n - 1, max(-1, n - 1 - connections), -1)))
    with mapper.store.lock:
        n, _, v = mapper.store.snapshot()
        problem, start, umask, _, _ = mapper._compact_step_inputs(n, v, True)
    return start, ba.prepare_problem(problem, pyr), umask, pyr, cfg


def prep_times(variables, problem, pyr, cfg, card: str, peak_bw: float, label: str) -> dict:
    """The prep kernel and the plain chain timed on one linearization's
    edges (cold L2, the warm reading beside) against the kernel's bound.
    Launches made here are not counted."""
    from sage_slam_tpu_torch.ops import photo_prep as pp
    from sage_slam_tpu_torch.solver import ba

    pe, w, soft = problem.photo_edges, problem.window, cfg.soft_inlier_gate
    saved = pp.photo_prep_edges.launches

    def kernel():
        ba._photo_prep(variables, w, pe, pyr, cfg.dpt_eps, soft)

    def plain():
        _plain_prep(variables, w, pe, pyr, cfg, soft)

    prep = ba._photo_prep(variables, w, pe, pyr, cfg.dpt_eps, soft)
    bound_ms, nbytes = prep_bound(prep, problem, slice(None), peak_bw)
    del prep
    reps = 20
    t = dict(ms=device_ms(kernel, reps, "photo_prep", cold=True), warm_ms=device_ms(kernel, reps, "photo_prep"),
             plain_ms=device_ms(plain, reps, cold=True), warm_plain_ms=device_ms(plain, reps),
             events_ms=cuda_ms(kernel, reps), bound_ms=bound_ms, bytes=nbytes,
             E=int(pe.i0.shape[0]), N=int(w.loc1d.shape[1]))
    pp.photo_prep_edges.launches = saved
    say(f"time [{card}] prep kernel at {label} (E={t['E']}, N={t['N']}): device cold L2 {t['ms']:.6f} ms "
        f"({bound_ms / t['ms']:.1%} of its bound {bound_ms:.6f} ms, {nbytes / 1e6:.1f} MB), warm "
        f"{t['warm_ms']:.6f} ms, CUDA events around {reps} warm wrapper calls {t['events_ms']:.5f} ms a "
        f"call; the plain chain cold {t['plain_ms']:.4f} ms, warm {t['warm_plain_ms']:.4f} ms "
        f"({t['plain_ms'] / t['ms']:.1f}x the kernel, cold)")
    if bound_ms / t["ms"] > K1_MAX_SHARE:
        fail(f"prep kernel at {label}: cold reading {t['ms']:.6f} ms is {bound_ms / t['ms']:.1%} of its bound")
    return t


def run_ba_counts(variables, problem, pyr, cfg, mask, label: str) -> dict:
    """run_ba on a problem with utils/timing recording: one prep launch,
    one photo.prep_kernel count and one K1 launch an LM iteration, and in
    every lin.photo span the instantiations' widths (photo.k1_pad,
    photo.prep_cs) of the problem's code size -> the widths."""
    from sage_slam_tpu_torch.ops import photo_prep as pp
    from sage_slam_tpu_torch.ops import photo_reduce as pr
    from sage_slam_tpu_torch.solver import ba
    from sage_slam_tpu_torch.utils import timing

    cs = variables.code_size
    want = dict(k1_pad=pr.pad_for(13 + cs), prep_cs=pp.code_width(cs))
    timing.reset()
    timing.enable(True)
    launches, k1 = pp.photo_prep_edges.launches, pr.photo_reduce.launches
    _, err, iters, _ = ba.run_ba(variables, problem, pyr, cfg, mask, cfg.max_gn_iters)
    timing.enable(False)
    launches, k1 = pp.photo_prep_edges.launches - launches, pr.photo_reduce.launches - k1
    spans = [r for r in timing.records() if r.name == "lin.photo"]
    timing.reset()
    counted = sum(r.counts.get("photo.prep_kernel", 0) for r in spans)
    widths = {(r.counts.get("photo.k1_pad"), r.counts.get("photo.prep_cs")) for r in spans}
    say(f"prep kernel on {label} (CS={cs}): run_ba {iters} LM iterations, error {float(err):.6g}; prep "
        f"launches {launches}, photo.prep_kernel counts {counted}, K1 launches {k1}; (photo.k1_pad, "
        f"photo.prep_cs) in its {len(spans)} lin.photo spans: {sorted(widths)}")
    if not (launches == counted == k1 == iters == len(spans)) or not bool(torch.isfinite(err)):
        fail(f"run_ba on {label}: {launches} prep launches, {counted} counted, {k1} K1 launches "
             f"for {iters} LM iterations (error {float(err)})")
    if widths != {(want["k1_pad"], want["prep_cs"])}:
        fail(f"run_ba on {label}: lin.photo counted (photo.k1_pad, photo.prep_cs) {sorted(widths)}, "
             f"expected {(want['k1_pad'], want['prep_cs'])}")
    return dict(launches=launches, **want)


def cell_k1(variables, problem, pyr, cfg, card: str, peaks, label: str) -> dict:
    """K1 on the kernel's prep of a cell's problem: held to its plain
    version and timed against its bound (k1_hold)."""
    from sage_slam_tpu_torch.ops import photometric
    from sage_slam_tpu_torch.solver import ba

    prep = ba._photo_prep(variables, problem.window, problem.photo_edges, pyr, cfg.dpt_eps,
                          cfg.soft_inlier_gate)
    weights, ratios = tuple(cfg.photo_factor_weights), photometric.level_ratios(pyr)
    return k1_hold(prep, weights, ratios, card, peaks, label)["shape"]


def prep_path(dev, card: str, peaks) -> dict:
    """Phase 14: the prep kernel against the plain chain at the shapes the
    port gives it, each with three variants and both gates, at CS = 16 and
    CS = 32; one prep launch an LM iteration of run_ba on the cells'
    problems, with the instantiations' widths counted; times of the prep
    kernel at the bench point and the cells' shapes, and of K1 on the
    cells' prep at both widths."""
    from sage_slam_tpu_torch import synthetic
    from sage_slam_tpu_torch.bench import scaling
    from sage_slam_tpu_torch.config import MapperConfig
    from sage_slam_tpu_torch.ops import photo_prep as pp
    from sage_slam_tpu_torch.solver import ba

    t0 = time.perf_counter()
    peak_bw = peaks[0]
    mcfg = MapperConfig()
    shapes = []
    v, p, pyr = synthetic.bench_problem(device=dev)
    shapes.append(("the bench point", v, ba.prepare_problem(p, pyr), pyr, mcfg))
    v, p, pyr = synthetic.bench_problem(device=dev, n_photo=48, n_geo=48)
    shapes.append(("a mapper window", v, ba.prepare_problem(p, pyr), pyr, mcfg))
    for g in scaling.growth_points(dev):
        pass  # the last graph, drawn after the others as growth_curve draws it
    shapes.append((f"growth_curve's full step at {g.keyframes} keyframes", g.variables,
                   ba.prepare_problem(g.problems["full"], g.cam_pyr), g.cam_pyr, mcfg))
    del g
    cells = {cs: cell_problem(dev, code_size=cs) for cs in (16, 32)}
    shapes.append(("the cell's problem", cells[16][0], cells[16][1], cells[16][3], cells[16][4].mapper))
    v, p, pyr = synthetic.bench_problem(device=dev, cs=32)
    shapes.append(("the bench point at CS=32", v, ba.prepare_problem(p, pyr), pyr, mcfg))
    v, p, pyr = synthetic.bench_problem(device=dev, cs=32, n_photo=48, n_geo=48)
    shapes.append(("a mapper window at CS=32", v, ba.prepare_problem(p, pyr), pyr, mcfg))
    shapes.append(("the CS=32 cell's problem", cells[32][0], cells[32][1], cells[32][3],
                   cells[32][4].mapper))
    faults, worst = [], {}
    for i, (label, v, p, pyr, cfg) in enumerate(shapes):
        for vlabel, vv, w in prep_variants(v, p.window, seed=40 + i):
            for soft in (False, True):
                stats, bad = prep_compare(vv, w, p.photo_edges, pyr, cfg, soft, f"{label}, {vlabel},")
                faults += [f"{label}, {vlabel}, {'soft' if soft else 'hard'} gate: {f}" for f in bad]
                for key, val in stats.items():
                    if isinstance(val, float):
                        worst[key] = max(worst.get(key, 0.0), val)
    if faults:
        fail("prep kernel against the plain chain:\n  " + "\n  ".join(faults))
    counts = {cs: run_ba_counts(c[0], c[1], c[3], c[4].mapper, c[2], f"the CS={cs} cell's problem")
              for cs, c in cells.items()}
    times = {"bench": prep_times(*shapes[0][1:], card, peak_bw, "the bench point"),
             "cell": prep_times(cells[16][0], cells[16][1], cells[16][3], cells[16][4].mapper, card,
                                peak_bw, "the cell's problem"),
             "bench_cs32": prep_times(*shapes[4][1:], card, peak_bw, "the bench point at CS=32"),
             "cell_cs32": prep_times(cells[32][0], cells[32][1], cells[32][3], cells[32][4].mapper,
                                     card, peak_bw, "the CS=32 cell's problem")}
    k1 = {cs: cell_k1(c[0], c[1], c[3], c[4].mapper, card, peaks,
                      f"the CS={cs} cell's prep (dim {13 + cs}, pad {counts[cs]['k1_pad']})")
          for cs, c in cells.items()}
    secs = time.perf_counter() - t0
    say(f"phase 14 took {secs:.1f} s")
    return dict(worst=worst, times=times, k1=k1, run_ba_launches=counts[16]["launches"],
                run_ba_launches_cs32=counts[32]["launches"], seconds=secs, cells=cells)


# ---- 15. the Hessian assembly kernel (solver/graph, csrc/hessian_assembly.cu) ----

# The kernel and the one-hot path sum the same float32 products in other
# orders, and both against a float64 sum: each entry is a sum of at most a
# few dozen blocks' entries, so both stay within a few float32 ulps of the
# largest entry; a misplaced block reads of the order of max |H| itself.
ASSEMBLY_RTOL = 1e-5  # of max |H| (and of max |b| for b)
ASSEMBLY_CALLS = ("photo", "geo", "code prior", "scale prior", "pose prior")


def assembly_calls(variables, problem, pyr, cfg):
    """The scatter_hessian calls of one ba.linearize, their inputs kept (the
    kernel writes only h and b) -> ([(gidx, ata, atb, valid, block_dim)],
    H, b of the linearization)."""
    from sage_slam_tpu_torch.solver import ba, graph

    calls, real = [], graph.scatter_hessian

    def spy(h, b, *args):
        calls.append(args)
        return real(h, b, *args)

    graph.scatter_hessian = spy
    try:
        h, b, _ = ba.linearize(variables, problem, pyr, cfg)
    finally:
        graph.scatter_hessian = real
    return calls, h, b


def assembly_bound(calls, d: int, peak_bw: float):
    """The kernel's least time for these calls: the valid edges' indices,
    blocks and vectors read once, and once each read and written the tiles
    of H and the rows of b that an edge touches, at the memory rate ->
    (ms, bytes)."""
    from sage_slam_tpu_torch.solver import graph

    nbytes = 0
    for gidx, ata, atb, valid, bd in calls:
        live = valid != 0
        g = gidx[live]
        e, s = g.shape
        nbytes += e * s * (8 + 4) + e * s * s * 4 + e * 4
        t = graph.tile_width(bd)
        inside = (g >= 0) & (g < d)
        tiles = set()
        for row, ok in zip((g // t).tolist(), inside.tolist()):
            rows = {r for r, o in zip(row, ok) if o}
            tiles |= {(a, c) for a in rows for c in rows}
        for a, c in tiles:
            nbytes += 2 * 4 * min(t, d - a * t) * min(t, d - c * t)
            if a == c:
                nbytes += 2 * 4 * min(t, d - a * t)
    return nbytes / peak_bw * 1e3, nbytes


def _index_add_sum(h, b, gidx, ata, atb, valid):
    """float64 H and b with every edge's valid² · block and valid · vector
    added entry by entry, on the card."""
    d = h.shape[-1]
    e, s = gidx.shape
    keep = (gidx >= 0) & (gidx < d)
    pair = keep[:, :, None] & keep[:, None, :]
    v = valid.double()
    hs = h.double().reshape(-1).clone()
    hs.index_add_(0, (gidx[:, :, None] * d + gidx[:, None, :])[pair],
                  (ata.double() * (v * v)[:, None, None]).expand(e, s, s)[pair])
    bs = b.double().clone()
    bs.index_add_(0, gidx[keep], (atb.double() * v[:, None]).expand(e, s)[keep])
    return hs.reshape(d, d), bs


def assembly_hold(calls, h_lin, b_lin, k: int, label: str) -> dict:
    """Each call's kernel result against the one-hot path and the float64
    sum, two calls bitwise equal, H exactly symmetric; the five replayed in
    order equal bitwise to the linearization's H and b -> worst errors."""
    from sage_slam_tpu_torch.solver import graph

    d = h_lin.shape[0]
    worst = dict(kernel=0.0, one_hot=0.0)
    h_all, b_all = graph.empty_system(k, d // k, device=h_lin.device)
    for name, (gidx, ata, atb, valid, bd) in zip(ASSEMBLY_CALLS, calls):
        h0, b0 = graph.empty_system(k, bd, device=h_lin.device)
        h1, b1 = graph.scatter_hessian(h0.clone(), b0.clone(), gidx, ata, atb, valid, bd)
        h2, b2 = graph.scatter_hessian(h0.clone(), b0.clone(), gidx, ata, atb, valid, bd)
        ho, bo = graph.scatter_hessian_ref(h0, b0, gidx, ata, atb, valid)
        hr, br = _index_add_sum(h0, b0, gidx, ata, atb, valid)
        torch.cuda.synchronize()
        if not (torch.equal(h1, h2) and torch.equal(b1, b2)):
            fail(f"assembly kernel at {label}, {name}: two calls on the same inputs differ")
        if not torch.equal(h1, h1.T):
            fail(f"assembly kernel at {label}, {name}: H is not exactly symmetric")
        hs, bs = float(hr.abs().max()), max(float(br.abs().max()), 1e-30)
        errs = dict(kernel=max(float((h1.double() - hr).abs().max()) / hs,
                               float((b1.double() - br).abs().max()) / bs),
                    one_hot=max(float((ho.double() - hr).abs().max()) / hs,
                                float((bo.double() - br).abs().max()) / bs))
        e, s = gidx.shape
        say(f"assembly kernel at {label}, {name} (E={e}, S={s}, D={d}, tile {graph.tile_width(bd)}): "
            f"max error over max |H| against float64 {errs['kernel']:.3g} (the one-hot path "
            f"{errs['one_hot']:.3g}); two calls bit-equal, H exactly symmetric: ok")
        if errs["kernel"] > ASSEMBLY_RTOL:
            fail(f"assembly kernel at {label}, {name}: error {errs['kernel']:.3g} over {ASSEMBLY_RTOL}")
        worst = {key: max(worst[key], val) for key, val in errs.items()}
        h_all, b_all = graph.scatter_hessian(h_all, b_all, gidx, ata, atb, valid, bd)
    if not (torch.equal(h_all, h_lin) and torch.equal(b_all, b_lin)):
        fail(f"assembly kernel at {label}: the five calls replayed differ from the linearization's H, b")
    if not torch.equal(h_lin, h_lin.T):
        fail(f"assembly kernel at {label}: the linearization's H is not exactly symmetric")
    return worst


def assembly_counts(variables, problem, pyr, cfg, mask, label: str) -> int:
    """run_ba with utils/timing recording: every graph.scatter_hessian span
    counts one assembly.kernel, five an LM iteration -> kernel calls."""
    from sage_slam_tpu_torch.solver import ba, graph
    from sage_slam_tpu_torch.utils import timing

    timing.reset()
    timing.enable(True)
    before = graph._scatter_kernel.calls
    _, _, iters, _ = ba.run_ba(variables, problem, pyr, cfg, mask, cfg.max_gn_iters)
    timing.enable(False)
    calls = graph._scatter_kernel.calls - before
    spans = [r for r in timing.records() if r.name == "graph.scatter_hessian"]
    timing.reset()
    counted = sum(r.counts.get("assembly.kernel", 0) for r in spans)
    say(f"assembly kernel on {label}: run_ba {iters} LM iterations, {len(spans)} scatter_hessian "
        f"spans, assembly.kernel counted {counted}, kernel calls {calls}")
    if not calls == counted == len(spans) == 5 * iters:
        fail(f"run_ba on {label}: {calls} assembly calls, {counted} counted, {len(spans)} spans for "
             f"{iters} LM iterations (expected 5 each)")
    return calls


def assembly_times(calls, k: int, card: str, peak_bw: float, label: str) -> dict:
    """The kernel timed per call and over the five together (cold L2, warm
    beside) against assembly_bound, the one-hot path beside. Calls made
    here are not counted."""
    from sage_slam_tpu_torch.solver import graph

    saved = graph._scatter_kernel.calls
    d = k * calls[0][4]
    dev = calls[0][0].device
    h, b = graph.empty_system(k, calls[0][4], device=dev)
    reps = 20

    def kernel(group):
        def run():
            for gidx, ata, atb, valid, bd in group:
                graph.scatter_hessian(h, b, gidx, ata, atb, valid, bd)
        return run

    def one_hot(group):
        def run():
            for gidx, ata, atb, valid, _ in group:
                graph.scatter_hessian_ref(h, b, gidx, ata, atb, valid)
        return run

    out = {}
    for name, group in [*((n, [c]) for n, c in zip(ASSEMBLY_CALLS, calls)), ("all five", calls)]:
        bound_ms, nbytes = assembly_bound(group, d, peak_bw)
        t = dict(ms=device_ms(kernel(group), reps, "assembly_", cold=True),
                 warm_ms=device_ms(kernel(group), reps, "assembly_"),
                 plain_ms=device_ms(one_hot(group), reps, cold=True),
                 warm_plain_ms=device_ms(one_hot(group), reps), bound_ms=bound_ms, bytes=nbytes)
        say(f"time [{card}] assembly kernel at {label}, {name}: device cold L2 {t['ms']:.6f} ms "
            f"({bound_ms / t['ms']:.1%} of its bound {bound_ms:.6f} ms, {nbytes / 1e6:.2f} MB), warm "
            f"{t['warm_ms']:.6f} ms ({bound_ms / t['warm_ms']:.1%}); the one-hot path cold "
            f"{t['plain_ms']:.4f} ms, warm {t['warm_plain_ms']:.4f} ms")
        out[name] = t
    graph._scatter_kernel.calls = saved
    return out


def assembly_path(dev, card: str, peaks, cells=None) -> dict:
    """Phase 15: the Hessian assembly kernel on both cells' problems (see
    the module note); ``cells`` as phase 14 built them, else built here."""
    t0 = time.perf_counter()
    if cells is None:
        cells = {cs: cell_problem(dev, code_size=cs) for cs in (16, 32)}
    worst, times, counts = {}, {}, {}
    for cs, (variables, problem, mask, pyr, scfg) in cells.items():
        label = f"the CS={cs} cell's problem"
        calls, h_lin, b_lin = assembly_calls(variables, problem, pyr, scfg.mapper)
        if len(calls) != len(ASSEMBLY_CALLS):
            fail(f"ba.linearize on {label} made {len(calls)} scatter_hessian calls, expected 5")
        k = variables.num_kf
        for key, val in assembly_hold(calls, h_lin, b_lin, k, label).items():
            worst[key] = max(worst.get(key, 0.0), val)
        counts[f"CS={cs}"] = assembly_counts(variables, problem, pyr, scfg.mapper, mask, label)
        times[f"CS={cs}"] = assembly_times(calls, k, card, peaks[0], label)
    secs = time.perf_counter() - t0
    say(f"phase 15 took {secs:.1f} s")
    return dict(worst=worst, times=times, run_ba_calls=counts, seconds=secs)


# ---- 16. the geometric factor's linearization (ops/geo_linearize, csrc/geo_linearize.cu) ----

# Tolerances of the kernels against the plain chain (build_frame1_tables +
# geometric_jac_error) on the same inputs: the linearize tolerance of phase
# 4 (rtol 1e-4, atol 1e-5 of max |ata| for ata and atb; rtol 1e-4 for the
# error), the Gram summed over 3,072 points in another order and the rows
# computed from coordinates summed in another order. n_inl is a count and
# must be exact. Every edge is held: a point whose nearest-pixel mask or
# z > eps test changes within GEO_STEP_PX of the plain chain's coordinates
# (a few float32 ulps apart from the kernel's) may fall on the other side
# in the kernel, so an edge that misses the plain chain and has such step
# points is held instead against the plain chain with some of them flipped
# (geo_hold searches the subsets, at most GEO_FLIP_MAX points an edge).
GEO_RTOL, GEO_ATOL = 1e-4, 1e-5
GEO_STEP_PX = 1e-3
GEO_FLIP_MAX = 8
# run_ba on a cell's problem, card against CPU: the worst keyframe's gap
# over how far the CPU run moved it (read 1.4e-5 at CS = 16 and 3.0e-5 at
# CS = 32 on an H100)
GEO_RUN_BA_ITERS, GEO_RUN_BA_GAP = 2, 1e-3


def geo_bound(window, edges, cs: int, peak_bw: float, peak_flops: float, splits: int, pad: int):
    """The kernels' least time for these edges: the larger of the FP32
    operations E N (D (D + 1) + 2 D), D = 14 + 2CS (the geometric term of
    benchmark/peaks.lm_iteration_flops), over the peak rate, and the bytes
    over the memory rate: the table launch's reads of every keyframe's bias
    and code basis and the mask and its frame-1 table [K, HW, 4] written;
    the split launch's reads of the distinct source keyframes' rows (homo,
    bias and code basis at the sampled points) and the distinct target
    frames' table and code basis, and its partials [E, splits, pad, pad]
    written; the combine's reads of the partials and the outputs written
    -> (ms, "operations" | "bytes", flops, bytes)."""
    k, n = window.loc1d.shape
    hw = window.bias_flat.shape[1]
    e = edges.i0.shape[0]
    d = 14 + 2 * cs
    flops = e * n * (d * (d + 1) + 2 * d)
    targets = len(set(edges.i1.tolist()))
    nbytes = (k * hw * (1 + cs) * 4 + hw * 4 + k * hw * 16
              + len(set(edges.i0.tolist())) * n * (3 + 1 + cs) * 4 + targets * hw * (16 + cs * 4)
              + 2 * e * splits * pad * pad * 4 + e * (d * d + d + 2) * 4)
    t_ops, t_bytes = flops / peak_flops, nbytes / peak_bw
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes", flops, nbytes


def _geo_plain(v, w, ge, cam, cfg):
    from sage_slam_tpu_torch.ops import geometric
    from sage_slam_tpu_torch.solver import ba

    kf0, kf1, shared = ba._geo_inputs(w, ge, v, cam, which="full")
    return geometric.geometric_jac_error(
        ba._edge_pose(v, ge.i0), ba._edge_pose(v, ge.i1), v.code[ge.i0], v.code[ge.i1],
        v.scale[ge.i0], v.scale[ge.i1], kf0, kf1, shared, cam, cfg.geo_factor_weight,
        cfg.geo_loss_param_factor * w.avg_sq_bias[ge.i0], cfg.dpt_eps)


def _geo_kernel(v, w, ge, cam, cfg):
    from sage_slam_tpu_torch.ops import geo_linearize

    return geo_linearize.geo_linearize_edges(
        v.pose.rot, v.pose.trans, v.code, v.scale, ge.i0, ge.i1, w, cam,
        cfg.geo_loss_param_factor, cfg.geo_factor_weight, cfg.dpt_eps)


def _geo_plain_flipped(v, w, ge, cam, cfg, flip_mask, flip_pos):
    """The plain chain with its nearest-pixel mask (within) flipped at the
    points of ``flip_mask`` and its z > eps test (pos) at those of
    ``flip_pos`` ([E, N] bool): what it gives where the kernel's
    coordinates fall on the other side of those steps. A point the plain
    chain puts behind is projected at z = 1 there, so flipping its pos on
    does not give the kernel's rows: such an edge stays unheld."""
    from sage_slam_tpu_torch.geometry import interp
    from sage_slam_tpu_torch.ops import geometric

    select, warp = interp.quad_nearest_select_cm, geometric._warp_project_cm

    def flip(t, at):
        return torch.where(at, 1.0 - t, t)

    def select_flipped(*args, **kw):
        return flip(select(*args, **kw), flip_mask)

    def warp_flipped(*args, **kw):
        out = list(warp(*args, **kw))
        out[5] = flip(out[5], flip_pos)
        return tuple(out)

    interp.quad_nearest_select_cm, geometric._warp_project_cm = select_flipped, warp_flipped
    try:
        return _geo_plain(v, w, ge, cam, cfg)
    finally:
        interp.quad_nearest_select_cm, geometric._warp_project_cm = select, warp


def _geo_steps(v, w, ge, cam, cfg):
    """([E, N], [E, N]) bool: the points whose mask at the nearest pixel
    (half up) changes within GEO_STEP_PX of the plain chain's coordinates,
    and those whose z > eps test does."""
    from sage_slam_tpu_torch.ops import photometric
    from sage_slam_tpu_torch.solver import ba

    kf0, _, shared = ba._geo_inputs(w, ge, v, cam, which="full")
    out = photometric._warp_project_cm(ba._edge_pose(v, ge.i0), ba._edge_pose(v, ge.i1),
                                       v.code[ge.i0], v.scale[ge.i0], kf0, shared, cam, cfg.dpt_eps)
    x1, u, vv = out[4], out[6], out[7]

    def nearest(x, y):
        fx, fy = torch.floor(x), torch.floor(y)
        xr = (fx + ((x - fx) >= 0.5)).nan_to_num(-2.0).clamp(-2, cam.width + 1)
        yr = (fy + ((y - fy) >= 0.5)).nan_to_num(-2.0).clamp(-2, cam.height + 1)
        inb = (xr >= 0) & (xr < cam.width) & (yr >= 0) & (yr < cam.height)
        idx = (yr.clamp(0, cam.height - 1) * cam.width + xr.clamp(0, cam.width - 1)).long()
        return w.mask_flat[idx] * inb

    centre = nearest(u, vv)
    step = torch.zeros_like(centre, dtype=torch.bool)
    for du, dv in ((GEO_STEP_PX, 0.0), (-GEO_STEP_PX, 0.0), (0.0, GEO_STEP_PX), (0.0, -GEO_STEP_PX)):
        step |= nearest(u + du, vv + dv) != centre
    return step, (x1[:, 2] - cfg.dpt_eps).abs() < GEO_STEP_PX * cfg.dpt_eps


def geo_hold(got, plain, mask_step, z_step):
    """Hold every edge of the kernels' outputs ``got`` (ata, atb, error,
    n_inl) to the plain chain: n_inl exact, ata and atb within GEO_RTOL +
    GEO_ATOL of max |ata|, the error within GEO_RTOL. ``plain(flip_mask,
    flip_pos)`` runs the plain chain with the mask and z tests flipped at
    the [E, N] points given. An edge that misses the unflipped chain and has
    step points (``mask_step``, ``z_step``) is held against the chain with
    a subset of its step points flipped, the subsets tried in order -> (the
    reference each edge was held to, its flipped points an edge [E], the
    edges held [E] bool)."""
    ata, atb, err, n = (x.double().cpu() for x in got)
    best = [x.double().cpu() for x in plain(torch.zeros_like(mask_step), torch.zeros_like(z_step))]
    scale = float(best[0].nan_to_num(0.0).abs().max().clamp(min=1e-30))

    def held(ref):
        ok = torch.eq(n, ref[3])
        for a, b, atol in ((ata, ref[0], GEO_ATOL * scale), (atb, ref[1], GEO_ATOL * scale),
                           (err, ref[2], 0.0)):
            close = torch.isclose(a, b, rtol=GEO_RTOL, atol=atol, equal_nan=True)
            ok &= close.reshape(len(n), -1).all(dim=1)
        return ok

    ok = held(best)
    step = mask_step | z_step
    counts = step.sum(dim=1).cpu()
    flips = torch.zeros(len(n), dtype=torch.long)
    todo = ~ok & (counts > 0) & (counts <= GEO_FLIP_MAX)
    rank = step.cumsum(dim=1) - 1  # each step point's place among its edge's
    for subset in range(1, 2 ** int(counts[todo].max()) if bool(todo.any()) else 1):
        at = step & ((subset >> rank.clamp(min=0)) & 1).bool() & todo.to(step.device)[:, None]
        ref = [x.double().cpu() for x in plain(at & mask_step, at & z_step)]
        hit = todo & held(ref)
        for b, r in zip(best, ref):
            b[hit] = r[hit]
        flips[hit] = at.sum(dim=1).cpu()[hit]
        ok |= hit
        todo &= ~hit
        if not bool(todo.any()):
            break
    return best, flips, ok


def geo_compare(v, w, ge, cam, cfg, label: str):
    """The kernels' four outputs against the plain chain's (the tolerances
    are GEO_*'s), two calls bit-equal, ata exactly symmetric -> (stats,
    faults)."""
    from sage_slam_tpu_torch.ops import geo_linearize

    before = geo_linearize.geo_linearize_edges.launches
    got = [x.clone() for x in _geo_kernel(v, w, ge, cam, cfg)]
    again = _geo_kernel(v, w, ge, cam, cfg)
    mask_step, z_step = _geo_steps(v, w, ge, cam, cfg)
    ref, flips, ok = geo_hold(
        got, lambda fm, fp: _geo_plain_flipped(v, w, ge, cam, cfg, fm, fp), mask_step, z_step)
    torch.cuda.synchronize()
    faults = []
    bits = lambda t: t.contiguous().view(torch.int32)  # noqa: E731  NaN equal to itself
    if geo_linearize.geo_linearize_edges.launches != before + 2:
        faults.append("two calls did not launch twice")
    if not all(torch.equal(bits(a), bits(b)) for a, b in zip(got, again)):
        faults.append("two calls on the same inputs differ")
    if not torch.equal(bits(got[0]), bits(got[0].transpose(-1, -2))):
        faults.append("ata is not exactly symmetric")
    ata, atb, err, _ = (x.double().cpu() for x in got)
    ata_r, atb_r, err_r, _ = ref
    steps = (mask_step | z_step).sum(dim=1).cpu()
    stats = dict(edges=len(ok), held=int(ok.sum()), step_edges=int((steps > 0).sum()),
                 step_points=int(steps.sum()), flipped_edges=int((flips > 0).sum()),
                 flipped_points=int(flips.sum()))
    if stats["held"] < stats["edges"]:
        faults.append(f"{stats['edges'] - stats['held']} of {stats['edges']} edges miss the plain chain "
                      f"(with no step point, or under every flip of at most {GEO_FLIP_MAX})")
    scale = float(ata_r.nan_to_num(0.0).abs().max().clamp(min=1e-30))
    for name, a, b, rel in (("ata", ata, ata_r, False), ("atb", atb, atb_r, False), ("error", err, err_r, True)):
        d = (a - b).nan_to_num(0.0).abs()
        stats[name] = float((d / b.nan_to_num(0.0).abs().clamp(min=1e-30) if rel else d / scale).max())
    say(f"geo kernel vs plain: {label} E={stats['edges']}: {stats['held']} of {stats['edges']} edges held "
        f"({stats['step_edges']} with {stats['step_points']} step points; {stats['flipped_edges']} held with "
        f"{stats['flipped_points']} flipped); |d| over max |ata|: ata {stats['ata']:.3g}, atb {stats['atb']:.3g}; "
        f"relative: error {stats['error']:.3g}; two calls bit-equal, ata symmetric: "
        f"{'ok' if not faults else 'FAULTS: ' + '; '.join(faults)}")
    return stats, faults


def geo_times(v, w, ge, cam, cfg, card: str, peaks, label: str) -> dict:
    """The kernels, the plain chain and torch.bmm of the Gram alone (rows
    @ rows^T + rows @ diff on drawn [E, D, N] rows, the library call) timed
    cold (flush_l2 between calls) and warm against geo_bound. Launches made
    here are not counted."""
    from sage_slam_tpu_torch.ops import geo_linearize

    saved = geo_linearize.geo_linearize_edges.launches
    cs = v.code.shape[1]
    e, n, d = ge.i0.shape[0], w.loc1d.shape[1], 14 + 2 * cs
    width = geo_linearize.code_width(cs)
    splits = geo_linearize.num_splits(n, e, geo_linearize._slots(ge.i0.device.index, width))
    bound_ms, bound_by, flops, nbytes = geo_bound(w, ge, cs, *peaks, splits,
                                                  geo_linearize._library().geo_linearize_pad(width))
    rows = torch.randn((e, d, n), device=ge.i0.device)
    diff = torch.randn((e, n, 1), device=ge.i0.device)

    def kernel():
        _geo_kernel(v, w, ge, cam, cfg)

    def plain():
        _geo_plain(v, w, ge, cam, cfg)

    def library():
        torch.bmm(rows, rows.transpose(1, 2))
        torch.bmm(rows, diff)

    reps = 20
    t = dict(ms=device_ms(kernel, reps, "geo_", cold=True), warm_ms=device_ms(kernel, reps, "geo_"),
             plain_ms=device_ms(plain, reps, cold=True), warm_plain_ms=device_ms(plain, reps),
             library_ms=device_ms(library, reps, cold=True), warm_library_ms=device_ms(library, reps),
             events_ms=cuda_ms(kernel, reps), bound_ms=bound_ms, bound_by=bound_by, flops=flops,
             bytes=nbytes, ops_ms=flops / peaks[1] * 1e3, bytes_ms=nbytes / peaks[0] * 1e3,
             splits=splits, E=e, N=n, D=d)
    t["split_ms"] = device_ms(kernel, reps, "geo_split_points", cold=True)
    geo_linearize.geo_linearize_edges.launches = saved
    say(f"time [{card}] geo kernels at {label} (E={e}, N={n}, D={d}): device cold L2 {t['ms']:.6f} ms "
        f"({bound_ms / t['ms']:.1%} of its bound {bound_ms:.6f} ms by {bound_by}: {flops / 1e9:.3f} GFLOP, "
        f"{nbytes / 1e6:.1f} MB with {splits} splits an edge: {t['ops_ms']:.6f} ms of operations, "
        f"{t['bytes_ms']:.6f} ms of bytes, {t['ops_ms'] / t['bytes_ms']:.2f}x), of it the split kernel {t['split_ms']:.6f} ms; warm {t['warm_ms']:.6f} ms "
        f"({bound_ms / t['warm_ms']:.1%}); CUDA events around {reps} warm wrapper calls "
        f"{t['events_ms']:.5f} ms a call; the plain chain cold {t['plain_ms']:.4f} ms, warm "
        f"{t['warm_plain_ms']:.4f} ms; torch.bmm of the Gram alone cold {t['library_ms']:.4f} ms, warm "
        f"{t['warm_library_ms']:.4f} ms")
    if bound_ms / t["ms"] > K1_MAX_SHARE:
        fail(f"geo kernels at {label}: cold reading {t['ms']:.6f} ms is {bound_ms / t['ms']:.1%} of the bound")
    return t


def geo_counts(variables, problem, pyr, cfg, mask, label: str) -> int:
    """run_ba with utils/timing recording: every lin.geo span counts one
    geo.kernel and the code width of the problem's CS, one kernel call an
    LM iteration -> kernel calls."""
    from sage_slam_tpu_torch.ops import geo_linearize
    from sage_slam_tpu_torch.solver import ba
    from sage_slam_tpu_torch.utils import timing

    width = geo_linearize.code_width(variables.code_size)
    timing.reset()
    timing.enable(True)
    before = geo_linearize.geo_linearize_edges.launches
    _, err, iters, _ = ba.run_ba(variables, problem, pyr, cfg, mask, cfg.max_gn_iters)
    timing.enable(False)
    calls = geo_linearize.geo_linearize_edges.launches - before
    spans = [r for r in timing.records() if r.name == "lin.geo"]
    timing.reset()
    counts = {(r.counts.get("geo.kernel"), r.counts.get("geo.code_width")) for r in spans}
    say(f"geo kernels on {label}: run_ba {iters} LM iterations, error {float(err):.6g}; {len(spans)} "
        f"lin.geo spans, kernel calls {calls}, (geo.kernel, geo.code_width) {sorted(counts)}")
    if not calls == len(spans) == iters or counts != {(1, width)} or not bool(torch.isfinite(err)):
        fail(f"run_ba on {label}: {calls} geo kernel calls, {len(spans)} lin.geo spans counting "
             f"{sorted(counts)} for {iters} LM iterations (expected one each, width {width})")
    return calls


def geo_run_ba_cpu(variables, problem, pyr, cfg, mask, label: str) -> float:
    """run_ba on a cell's problem on the card against the same call on CPU
    copies (the plain chains) at GEO_RUN_BA_ITERS iterations: the worst
    keyframe's distance between the two over the largest distance the CPU
    run moved a keyframe (translation, code, scale) -> that gap."""
    from sage_slam_tpu_torch import convert
    from sage_slam_tpu_torch.solver import ba

    def flat(v):
        return torch.cat([v.pose.trans, v.code, v.scale[:, None]], dim=1).double().cpu()

    t0 = time.perf_counter()
    out_g = ba.run_ba(variables, problem, pyr, cfg, mask, GEO_RUN_BA_ITERS)
    out_c = ba.run_ba(convert.to_device(variables, "cpu"), convert.to_device(problem, "cpu"), pyr, cfg,
                      mask.cpu(), GEO_RUN_BA_ITERS)
    start, card_v, cpu_v = flat(variables), flat(out_g[0]), flat(out_c[0])
    moved = float((cpu_v - start).norm(dim=1).max())
    gap = float((card_v - cpu_v).norm(dim=1).max()) / max(moved, 1e-30)
    say(f"run_ba on {label}, card against CPU, {GEO_RUN_BA_ITERS} iterations: iterations {out_g[2]} / "
        f"{out_c[2]}, error {float(out_g[1]):.6g} / {float(out_c[1]):.6g}, worst keyframe gap {gap:.3g} of "
        f"the largest move {moved:.4g} ({time.perf_counter() - t0:.1f} s)")
    if not gap < GEO_RUN_BA_GAP:
        fail(f"run_ba on {label}: card and CPU differ by {gap:.3g} of the move (limit {GEO_RUN_BA_GAP})")
    return gap


def geo_path(dev, card: str, peaks, cells=None) -> dict:
    """Phase 16: the geometric factor's kernels against the plain chain at
    the bench point, a mapper window and both cells' problems (E = 24, 48,
    372 at CS = 16 and 32), each with prep_variants' three variants; one
    kernel call an LM iteration of run_ba on the cells; times against
    geo_bound, the plain chain and torch.bmm of the Gram; run_ba card
    against CPU on both cells' problems. ``cells`` as phase 14 built them,
    else built here."""
    from sage_slam_tpu_torch import synthetic
    from sage_slam_tpu_torch.config import MapperConfig
    from sage_slam_tpu_torch.solver import ba

    t0 = time.perf_counter()
    if cells is None:
        cells = {cs: cell_problem(dev, code_size=cs) for cs in (16, 32)}
    mcfg = MapperConfig()
    shapes = []
    for cs in (16, 32):
        for label, kw in (("the bench point", {}), ("a mapper window", dict(n_photo=48, n_geo=48))):
            v, p, pyr = synthetic.bench_problem(device=dev, cs=cs, **kw)
            shapes.append((f"{label} at CS={cs}", v, ba.prepare_problem(p, pyr), pyr, mcfg))
        c = cells[cs]
        shapes.append((f"the CS={cs} cell's problem", c[0], c[1], c[3], c[4].mapper))
    faults, worst, held = [], {}, {}
    for i, (label, v, p, pyr, cfg) in enumerate(shapes):
        for vlabel, vv, w in prep_variants(v, p.window, seed=60 + i):
            stats, bad = geo_compare(vv, w, p.geo_edges, pyr[0], cfg, f"{label}, {vlabel},")
            faults += [f"{label}, {vlabel}: {f}" for f in bad]
            held[f"{label}, {vlabel}"] = {k: stats[k] for k in ("held", "edges", "flipped_edges")}
            for key, val in stats.items():
                if isinstance(val, float):
                    worst[key] = max(worst.get(key, 0.0), val)
    if faults:
        fail("geo kernels against the plain chain:\n  " + "\n  ".join(faults))
    counts, times, gaps = {}, {}, {}
    for cs, (v, p, mask, pyr, scfg) in cells.items():
        label = f"the CS={cs} cell's problem"
        counts[f"CS={cs}"] = geo_counts(v, p, pyr, scfg.mapper, mask, label)
        times[f"cell_cs{cs}"] = geo_times(v, p.window, p.geo_edges, pyr[0], scfg.mapper, card, peaks, label)
        gaps[f"CS={cs}"] = geo_run_ba_cpu(v, p, pyr, scfg.mapper, mask, label)
    for label, v, p, pyr, cfg in (shapes[0], shapes[3]):
        times[label] = geo_times(v, p.window, p.geo_edges, pyr[0], cfg, card, peaks, label)
    secs = time.perf_counter() - t0
    say(f"phase 16 took {secs:.1f} s")
    return dict(worst=worst, held=held, times=times, run_ba_calls=counts, run_ba_gaps=gaps, seconds=secs)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-source", default=None,
                    help="an earlier photo_reduce.cu to time in turns with the current kernel")
    args = ap.parse_args()
    t_start = time.perf_counter()
    # ---- 1. device ----
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this smoke run needs a GPU")
    sys.path.insert(0, ROOT)
    from sage_slam_tpu_torch import _build, convert, synthetic
    from sage_slam_tpu_torch.config import MapperConfig
    from sage_slam_tpu_torch.bench import card_line, peaks_for
    from sage_slam_tpu_torch.device import set_f32_precision
    from sage_slam_tpu_torch.ops import geo_linearize
    from sage_slam_tpu_torch.ops import photo_prep as pp
    from sage_slam_tpu_torch.ops import photo_reduce as pr
    from sage_slam_tpu_torch.ops import photometric
    from sage_slam_tpu_torch.solver import ba, graph

    dev = torch.device("cuda", 0)
    conf = os.path.join(ROOT, "sage_slam_tpu_torch", "_build", "kineto.conf")
    os.makedirs(os.path.dirname(conf), exist_ok=True)
    with open(conf, "w") as f:
        f.write(KINETO_CONF)
    os.environ.setdefault("KINETO_CONFIG", conf)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    say(f"card: {card}")
    say(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    set_f32_precision()
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        fail("TF32 is still allowed after set_f32_precision()")
    peak_key, peak_bw, peak_flops = peaks_for(kind)
    say(f"peaks used for bounds: {peak_key}: {peak_bw / 1e12} TB/s, "
        f"{peak_flops / 1e12} TFLOP/s FP32")

    # ---- 2. build ----
    t0 = time.perf_counter()
    built = _build.build()
    say(f"build: {len(built)} source(s) compiled in {time.perf_counter() - t0:.2f} s")
    for name, (secs, log) in built.items():
        say(f"build {name}: {secs:.2f} s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                say(f"  ptxas {name}: {line.strip()}")

    # ---- 3. kernel vs plain ----
    checks = [
        ((3, 4, 16, 512, 29), "test_pallas shape"),
        ((24, 4, 16, 3072, 29), "bench shape"),
        ((4, 4, 16, 1000, 17), "ragged N=1000, dim=17"),
        ((4, 4, 16, 1001, 29), "N=1001 (N % 4 != 0: scalar loads)"),
        ((2, 4, 16, 100, 29), "N=100 (under two tiles)"),
        ((1, 4, 16, 3072, 29), "E=1"),
        ((4, 4, 16, 1024, 17), "dim=17"),
        ((24, 4, 16, 3072, 45), "dim=45 (the 48-wide instantiation)"),
        ((4, 4, 16, 1001, 30), "N=1001, dim=30 (the least dim of the 48-wide one)"),
    ]
    max_err = max_rel = 0.0
    before = pr.photo_reduce.launches
    for i, ((e, lv, c, n, dim), label) in enumerate(checks):
        ratios = tuple((0.5**lvl, 0.5**lvl) for lvl in range(lv))
        for soft in (False, True):
            ins = reduce_inputs(e, lv, c, n, dim, soft, seed=10 + i, dev=dev)
            out = pr.photo_reduce(*ins, WEIGHTS, ratios)
            torch.cuda.synchronize()
            ref = pr.photo_reduce_ref(*ins, WEIGHTS, ratios)
            tag = f"{label} {'soft' if soft else 'binary'} gate"
            abs_err, rel_err = compare_reduce(out, ref, not soft, tag)
            max_err, max_rel = max(max_err, abs_err), max(max_rel, rel_err)
            say(f"kernel vs plain: photo_reduce {tag} E={e} L={lv} C={c} N={n} dim={dim}: ok")
    if pr.photo_reduce.launches != before + 2 * len(checks):
        fail("photo_reduce launch count did not rise with its launches")
    for e, lv, c, n, dim in ((24, 4, 16, 3072, 29), (4, 4, 16, 1001, 29)):
        ratios = tuple((0.5**lvl, 0.5**lvl) for lvl in range(lv))
        ins = reduce_inputs(e, lv, c, n, dim, True, seed=30, dev=dev)
        first = [x.clone() for x in pr.photo_reduce(*ins, WEIGHTS, ratios)]
        second = pr.photo_reduce(*ins, WEIGHTS, ratios)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(first, second)):
            fail(f"two photo_reduce launches on the same inputs differ (E={e} N={n})")
        say(f"kernel: two launches at E={e} N={n} dim={dim} are bit-identical: ok")

    # ---- 4. main path ----
    cfg = MapperConfig()
    variables, problem, pyr = synthetic.bench_problem(device=dev)
    k = variables.num_kf
    update_mask = torch.ones(k, device=dev)
    err0 = float(ba.total_error(variables, problem, pyr, cfg))
    torch.cuda.synchronize()
    pr.photo_reduce.launches = 0
    t0 = time.perf_counter()
    v_out, err, iters, converged = ba.run_ba(
        variables, problem, pyr, cfg, update_mask, max_iters=10
    )
    torch.cuda.synchronize()
    first_run_s = time.perf_counter() - t0
    launches = {"photo_reduce": pr.photo_reduce.launches}
    say(f"main path: run_ba K={k} E=24+24 N=3072 iterations={iters} "
        f"converged={converged} error {err0:.6g} -> {float(err):.6g} "
        f"(first run {first_run_s:.3f} s); launches {launches}")
    for name, count in launches.items():
        if count == 0:
            fail(f"kernel {name} was not launched on the main path")
    if launches["photo_reduce"] != iters:
        fail(f"photo_reduce launched {launches['photo_reduce']} times for {iters} iterations")
    for t in (v_out.pose.rot, v_out.pose.trans, v_out.code, v_out.scale, err):
        if not bool(torch.isfinite(t).all()):
            fail("run_ba returned non-finite values")
    if v_out.code.shape != (k, 16) or v_out.pose.rot.shape != (k, 3, 3):
        fail("run_ba returned variables of the wrong shape")
    if not float(err) <= err0:
        fail(f"run_ba raised the error: {err0} -> {float(err)}")

    # one linearize on the card against one on the CPU (plain reduce), same inputs
    prepared = ba.prepare_problem(problem, pyr)
    h_g, b_g, e_g = ba.linearize(variables, prepared, pyr, cfg)
    cpu_problem = convert.to_device(prepared, "cpu")
    cpu_vars = convert.to_device(variables, "cpu")
    h_c, b_c, e_c = ba.linearize(cpu_vars, cpu_problem, pyr, cfg)
    scale = float(h_c.abs().max())
    np.testing.assert_allclose(h_g.cpu().numpy(), h_c.numpy(), rtol=1e-4, atol=1e-5 * scale)
    np.testing.assert_allclose(b_g.cpu().numpy(), b_c.numpy(), rtol=1e-4, atol=1e-5 * scale)
    np.testing.assert_allclose(float(e_g), float(e_c), rtol=1e-4)
    say(f"linearize card vs CPU: max|dH| {float((h_g.cpu() - h_c).abs().max()):.4g} "
        f"of max|H| {scale:.4g}; error {float(e_g):.8g} vs {float(e_c):.8g}: ok")

    # a small problem's whole run_ba on the card against the CPU
    gv, gp, gpyr = synthetic.graft_problem(device="cpu")
    out_c = ba.run_ba(gv, gp, gpyr, cfg, torch.ones(gv.num_kf), max_iters=10)
    out_g = ba.run_ba(
        convert.to_device(gv, dev), convert.to_device(gp, dev), gpyr, cfg,
        torch.ones(gv.num_kf, device=dev), max_iters=10,
    )
    if (out_g[2], out_g[3]) != (out_c[2], out_c[3]):
        fail(f"graft run_ba iterations/converged differ: card {out_g[2:]} cpu {out_c[2:]}")
    np.testing.assert_allclose(
        out_g[0].pose.trans.cpu().numpy(), out_c[0].pose.trans.numpy(), atol=2e-6
    )
    np.testing.assert_allclose(out_g[0].code.cpu().numpy(), out_c[0].code.numpy(), atol=1e-6)
    say(f"graft problem run_ba card vs CPU: iterations {out_g[2]}, error "
        f"{float(out_g[1]):.6g} vs {float(out_c[1]):.6g}: ok")

    # the kernel on the main path's own inputs (one linearization's prep)
    pe = prepared.photo_edges
    kf0, fr1, shared = ba._photo_inputs(prepared.window, pe)
    prep = photometric.photo_prep(
        ba._edge_pose(variables, pe.i0), ba._edge_pose(variables, pe.i1),
        variables.code[pe.i0], variables.scale[pe.i0], kf0, fr1, shared,
        pyr, cfg.dpt_eps, soft=cfg.soft_inlier_gate,
    )
    ratios = photometric.level_ratios(pyr)
    weights = tuple(cfg.photo_factor_weights)
    out = pr.photo_reduce(*prep, weights, ratios)
    ref = pr.photo_reduce_ref(*prep, weights, ratios)
    abs_err, rel_err = compare_reduce(out, ref, False, "main-path prep inputs")
    max_err, max_rel = max(max_err, abs_err), max(max_rel, rel_err)
    say("kernel vs plain: photo_reduce on the main path's prep inputs "
        f"{tuple(prep[0].shape)}: ok")

    # ---- 5. times ----
    fgs, f0, gate, kx, ky = prep
    e, lv, c3, n = fgs.shape
    dim = kx.shape[1]
    bound_ms, bound_by, in_bytes, out_bytes, flops = reduce_bound(prep, peak_bw, peak_flops)
    probe = flush_probe(peak_bw, card)

    def run_kernel():
        pr.photo_reduce(fgs, f0, gate, kx, ky, weights, ratios)

    def run_plain():
        pr.photo_reduce_ref(fgs, f0, gate, kx, ky, weights, ratios)

    run_library = library_call(prep)
    # device time from the profiler's kernel durations, cold L2, the warm
    # readings beside (k1_times); CUDA events around 50 warm calls (they
    # also see the host's enqueue)
    t = k1_times(run_kernel, run_plain, run_library, bound_ms, "the bench point")
    kernel_ms, plain_ms, t_library = t["ms"], t["plain_ms"], t["library_ms"]
    reps = 50
    saved = pr.photo_reduce.launches
    ev_kernel, ev_plain, ev_library = (cuda_ms(fn, reps) for fn in (run_kernel, run_plain, run_library))
    pr.photo_reduce.launches = saved
    say(f"time [{card}] photo_reduce kernel device, cold L2 {kernel_ms:.6f} ms (warm L2 "
        f"{t['warm_ms']:.6f} ms = {bound_ms / t['warm_ms']:.1%} of bound; CUDA events around 50 warm "
        f"wrapper calls {ev_kernel:.5f} ms per call), plain device cold {plain_ms:.4f} ms (warm "
        f"{t['warm_plain_ms']:.4f}; events {ev_plain:.4f}), library bmm of the final contraction device "
        f"cold {t_library:.4f} ms (warm {t['warm_library_ms']:.4f}; events {ev_library:.4f}), "
        f"bound {bound_ms:.6f} ms by {bound_by} ({(in_bytes + out_bytes) / 1e6:.1f} MB, "
        f"{flops / 1e9:.3f} GFLOP) = {bound_ms / kernel_ms:.1%} of bound (cold), "
        f"at E={e} L={lv} C={c3 // 3} N={n} dim={dim}")
    old_ms = None
    if args.old_source:
        old = old_reduce(args.old_source, os.path.join(ROOT, "sage_slam_tpu_torch", "_build"))
        compare_reduce(old(fgs, f0, gate, kx, ky, weights, ratios), ref, False,
                       "old kernel, main-path prep inputs")

        def run_old():
            old(fgs, f0, gate, kx, ky, weights, ratios)

        turns = [device_ms(fn, reps, "photo_reduce", cold=True)
                 for fn in (run_old, run_kernel, run_kernel, run_old)]
        pr.photo_reduce.launches = saved
        old_ms, new_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
        say(f"time [{card}] old vs new photo_reduce in turns (old, new, new, old), device, cold L2: "
            f"{', '.join(f'{x:.5f}' for x in turns)} ms; old {old_ms:.5f} ms ({bound_ms / old_ms:.1%} of "
            f"bound), new {new_ms:.5f} ms ({bound_ms / new_ms:.1%}), speed-up {old_ms / new_ms:.3f}x")

    step_times, event_times = [], []
    for rep in range(4):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        ba.run_ba(variables, prepared, pyr, cfg, update_mask, max_iters=10)
        stop.record()
        torch.cuda.synchronize()
        if rep > 0:  # the first is warm-up
            step_times.append((time.perf_counter() - t0) * 1e3)
            event_times.append(start.elapsed_time(stop))
    say(f"time [{card}] run_ba 10-iteration step at the bench point: "
        f"{np.mean(step_times):.3f} ms host clock, {np.mean(event_times):.3f} ms "
        f"CUDA events, mean of {len(step_times)} (host runs "
        f"{', '.join(f'{t:.3f}' for t in step_times)})")

    # ---- 6. mapper path ----
    mapped = mapper_path(dev, card, (peak_bw, peak_flops))
    max_err, max_rel = max(max_err, mapped["max_abs_err"]), max(max_rel, mapped["max_rel_err"])

    # ---- 7. slam path ----
    slammed = slam_path(dev, card, (peak_bw, peak_flops))
    max_err, max_rel = max(max_err, slammed["max_abs_err"]), max(max_rel, slammed["max_rel_err"])

    # ---- 8. loop path and threaded driver ----
    looped = loop_path(dev, card, (peak_bw, peak_flops))
    max_err, max_rel = max(max_err, looped["max_abs_err"]), max(max_rel, looped["max_rel_err"])

    # ---- 9. demo path ----
    demoed = demo_path(dev, card, (peak_bw, peak_flops))
    max_err, max_rel = max(max_err, demoed["max_abs_err"]), max(max_rel, demoed["max_rel_err"])

    # ---- 10. train path ----
    trained = train_path(dev, card, (peak_bw, peak_flops))
    max_err, max_rel = max(max_err, trained["max_abs_err"]), max(max_rel, trained["max_rel_err"])

    # ---- 11. dense and diagnostic eval ----
    evaled = eval_path(dev, card, (peak_bw, peak_flops))
    max_err, max_rel = max(max_err, evaled["max_abs_err"]), max(max_rel, evaled["max_rel_err"])

    # ---- 12. the default-off paths and multi-device BA ----
    extra = extras_path(dev, card, (peak_bw, peak_flops), mapped.pop("mapper"))
    max_err, max_rel = max(max_err, extra["max_abs_err"]), max(max_rel, extra["max_rel_err"])

    # ---- 13. the measuring programs ----
    programs = programs_path(dev, card, (peak_bw, peak_flops))
    max_err, max_rel = max(max_err, programs["max_abs_err"]), max(max_rel, programs["max_rel_err"])

    # ---- 14. the prep kernel ----
    prepped = prep_path(dev, card, (peak_bw, peak_flops))

    # ---- 15. the Hessian assembly kernel ----
    cells = prepped.pop("cells")
    assembled = assembly_path(dev, card, (peak_bw, peak_flops), cells)

    # ---- 16. the geometric factor's linearization ----
    geo = geo_path(dev, card, (peak_bw, peak_flops), cells)

    # ---- 17. result ----
    kernels = [{
        "name": "photo_reduce",
        "route": "cuda",
        "source": "sage_slam_tpu_torch/ops/csrc/photo_reduce.cu",
        "replaces": "sage_slam_tpu/ops/pallas_kernels.py:118",
        "launches": (launches["photo_reduce"] + mapped["launches"] + slammed["launches"]
                     + looped["launches"] + looped["driver_launches"] + demoed["launches"]
                     + trained["launches"] + sum(evaled["launches"].values())
                     + sum(extra["launches"].values()) + sum(programs["launches"].values())),
        "launches_by_path": {"run_ba": launches["photo_reduce"], "mapper": mapped["launches"],
                             "slam": slammed["launches"], "loop": looped["launches"],
                             "driver": looped["driver_launches"], "demo": demoed["launches"],
                             "train": trained["launches"], **evaled["launches"],
                             **extra["launches"], **programs["launches"]},
        "max_abs_err": max_err,
        "max_rel_err": max_rel,
        "matched": True,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": t_library,
        "library_call": "torch.bmm of the final contraction kx@kgx^T + ky@kgy^T only",
        "timing": "device time, cold L2 (a 96 MB scratch buffer read three times before each call)",
        "warm_ms": t["warm_ms"],
        "events_ms": ev_kernel,
        "flush_probe": {"phase 5": probe, "phase 13": programs["probe"]},
        "mapper_shape": mapped["shape"],
        "slam_shape": slammed["shape"],
        "loop_shape": looped["shape"],
        "demo_shape": demoed["shape"],
        "make_eval_shape": evaled["make_eval_shape"],
        "gt_probe_shape": evaled["gt_probe_shape"],
        "mesh_shape": extra["mesh_shape"],
        "gloo_rank_shape": extra["rank_shape"],
        "program_shapes": programs["shapes"],
        "train_shape": {k: trained[k] for k in ("shape", "ms", "warm_ms", "plain_ms", "library_ms",
                                                 "bound_ms", "bound_by")},
        "backward": trained["backward"],
        "train_step_ms": trained["step_ms"],
        "cell_shapes": {f"CS={cs}": t for cs, t in prepped["k1"].items()},
    }, {
        "name": "photo_prep",
        "route": "cuda",
        "source": "sage_slam_tpu_torch/ops/csrc/photo_prep.cu",
        "replaces": None,
        "launches": pp.photo_prep_edges.launches,
        "run_ba_launches_at_the_cell": prepped["run_ba_launches"],
        "matched": True,
        "max_rel_err": prepped["worst"],
        "timing": "device time, cold L2 (a 96 MB scratch buffer read three times before each call)",
        "bench_shape": prepped["times"]["bench"],
        "cell_shape": prepped["times"]["cell"],
        "bench_shape_cs32": prepped["times"]["bench_cs32"],
        "cell_shape_cs32": prepped["times"]["cell_cs32"],
        "run_ba_launches_at_the_cs32_cell": prepped["run_ba_launches_cs32"],
    }, {
        "name": "hessian_assembly",
        "route": "cuda",
        "source": "sage_slam_tpu_torch/ops/csrc/hessian_assembly.cu",
        "replaces": None,
        "calls": graph._scatter_kernel.calls,
        "run_ba_calls_at_the_cells": assembled["run_ba_calls"],
        "matched": True,
        "max_rel_err": assembled["worst"],
        "timing": "device time, cold L2 (a 96 MB scratch buffer read three times before each call)",
        "cell_shapes": assembled["times"],
    }, {
        "name": "geo_linearize",
        "route": "cuda",
        "source": "sage_slam_tpu_torch/ops/csrc/geo_linearize.cu",
        "replaces": None,
        "calls": geo_linearize.geo_linearize_edges.launches,
        "run_ba_calls_at_the_cells": geo["run_ba_calls"],
        "run_ba_gap_card_against_cpu": geo["run_ba_gaps"],
        "matched": True,
        "max_rel_err": geo["worst"],
        "timing": "device time, cold L2 (a 96 MB scratch buffer read three times before each call)",
        "shapes": geo["times"],
    }]
    if old_ms is not None:
        kernels[0]["earlier_ms"] = old_ms
    say(f"chip_smoke took {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": kernels}))
    say(card_line())
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
