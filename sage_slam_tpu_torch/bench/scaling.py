"""Sharded window-BA throughput against mesh size, and mapping-step cost
against keyframe count (port of bench_scaling.py).

    python -m sage_slam_tpu_torch.bench.scaling [--device DEV] [--ranks N | --cpu N]
        [--growth-max 128]

``main``: the edge-sharded BA step (parallel/sharded_ba.sharded_run_ba, 1
LM iteration) on bench_scaling.py's problem (synthetic.bench_problem with
K=8, 64x80, N=1024 samples, 64 photometric + 64 geometric ring edges) over
meshes of 1, 2, 4 and 8 ranks, up to ``--ranks``: by default rank r on
card r (NCCL) up to the cards present; ``--device`` puts every rank on
that one device (gloo when ranks share it: ``--device cuda:0 --ranks 2``
runs two ranks on one card); ``--cpu N`` is ``--device cpu --ranks N``,
gloo ranks on the CPU that check the structure only, as bench_scaling.py's
virtual CPU mesh did. Each rank builds the problem from the seed on its
own device; the step is called on the same variables once to warm up and
``reps`` (5) times timed (not chained, as bench_scaling.py). Prints
``factors_per_second_sharded_ba`` per mesh size with ``devices`` and
``scaling_efficiency`` (rate / (1-rank rate x ranks)).

``growth_curve``: run_ba (1 LM iteration) on windows of K = 8, 16, 32,
64, 128 keyframes (up to ``--growth-max``; 0 skips it) built from one
random feature image, with the temporal chain in both directions and a
loop link from every 8th keyframe to the newest (``growth_points``); the
sliding window is the newest 8 keyframes. Times the windowed step (edges incident to the
window), the full-graph step and the compact step (the window-incident
keyframes gathered by ba.compact_problem_keyframes from the prepared
problem) and prints ``mapping_step_ms`` per K with ``keyframes``,
``windowed``, ``windowed_edges``, ``full``, ``full_edges``, ``compact`` and
``compact_keyframes``.

The records returned (not printed) also carry the LM iterations that
their steps ran, warm-up included: each rank's ``lm_iterations`` beside
its K1 ``launches``, and each growth row's ``lm_iterations``.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from .. import synthetic
from ..config import MapperConfig
from ..device import resolve_device
from ..geometry.camera import CameraPyramid
from ..geometry.se3 import SE3, se3_exp
from ..parallel import launch, sharded_ba
from ..solver import ba
from ..solver.graph import Variables
from . import emit, parser, start, sync

MESH_SIZES = (1, 2, 4, 8)
EDGES_PER_TYPE = 64
SAMPLES = 1024
GROWTH_SIZES = (8, 16, 32, 64, 128)
GROWTH_WINDOW = 8
LOOP_EVERY = 8


def _scaling_rank(mesh, samples: int, edges: int, reps: int) -> dict:
    """launch.spawn's body: this rank's share of the sharded step, timed
    -> seconds per step, K1's launches and the LM iterations over every
    step (warm-up included), this rank's photometric edges."""
    from ..ops.photo_reduce import photo_reduce

    dev = mesh.device
    variables, problem, pyr = synthetic.bench_problem(device=dev, n=samples, n_photo=edges,
                                                      n_geo=edges)
    local = sharded_ba.shard_problem(problem, mesh)
    cfg = MapperConfig()
    update_mask = torch.ones(variables.num_kf, device=dev)

    def step():
        return sharded_ba.sharded_run_ba(variables, local, pyr, cfg, update_mask, mesh, max_iters=1)

    launches = photo_reduce.launches
    iters = step()[2]
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = step()
        iters += out[2]
    sync(dev)
    seconds = (time.perf_counter() - t0) / reps
    if not bool(torch.isfinite(out[1])):
        raise RuntimeError("the sharded step's error is not finite")
    return {"seconds": seconds, "launches": photo_reduce.launches - launches, "lm_iterations": iters,
            "photo_edges": local.photo_edges.i0.shape[0]}


def scaling(max_ranks: int, device=None, reps: int = 5, samples: int = SAMPLES) -> list:
    """factors_per_second_sharded_ba on meshes up to ``max_ranks`` ranks
    -> the printed records, each with its ranks' results under "ranks"
    (not printed)."""
    out, base_rate = [], None
    for n in MESH_SIZES:
        if n > max_ranks:
            break
        devices = None if device is None else [str(device)] * n
        ranks = launch.spawn(_scaling_rank, n, args=(samples, EDGES_PER_TYPE, reps), devices=devices)
        rate = 2 * EDGES_PER_TYPE / ranks[0]["seconds"]
        base_rate = rate if base_rate is None else base_rate
        rec = emit({"metric": "factors_per_second_sharded_ba", "devices": n, "value": round(rate, 2),
                    "unit": "factors/s", "scaling_efficiency": round(rate / (base_rate * n), 3)})
        out.append(dict(rec, ranks=ranks))
    return out


def growth_pairs(k: int, window_size: int = GROWTH_WINDOW):
    """bench_scaling.py's graph of K keyframes -> (all directed pairs, the
    pairs incident to the newest ``window_size`` keyframes, the sorted ids
    of the window-incident keyframes)."""
    pairs = []
    for a in range(k - 1):
        pairs += [(a, a + 1), (a + 1, a)]
    for a in range(0, k - LOOP_EVERY, LOOP_EVERY):
        pairs += [(a, k - 1), (k - 1, a)]
    lo = k - window_size
    win_pairs = [p for p in pairs if p[0] >= lo or p[1] >= lo]
    ids = sorted(set(range(lo, k)) | {a for p in win_pairs for a in p})
    return pairs, win_pairs, ids


def _tile(w1: ba.WindowData, k: int) -> ba.WindowData:
    """One keyframe's window rows repeated for K keyframes."""
    def rows(t, axis):
        shape = list(t.shape)
        shape[axis] = k
        return t.expand(*shape).contiguous()

    return w1._replace(
        loc1d=rows(w1.loc1d, 0), homo=rows(w1.homo, 0), bias_flat=rows(w1.bias_flat, 0),
        jac_flat=rows(w1.jac_flat, 0), feat_pyr=rows(w1.feat_pyr, 1), grad_pyr=rows(w1.grad_pyr, 2),
        src_feats=rows(w1.src_feats, 0), avg_sq_bias=rows(w1.avg_sq_bias, 0),
    )


def _time_step(fn, dev, reps: int):
    """ms per call of a run_ba-like fn() after one warm-up call -> (ms,
    the LM iterations of every call)."""
    iters = fn()[2]
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        iters += fn()[2]
    sync(dev)
    return (time.perf_counter() - t0) / reps * 1000, iters


class GrowthPoint(NamedTuple):
    """growth_curve's inputs at one keyframe count."""

    keyframes: int
    variables: Variables
    update_mask: torch.Tensor  # the newest GROWTH_WINDOW keyframes
    problems: dict  # "windowed" / "full" -> ba.BAProblem
    compact: ba.BAProblem  # prepared, on the window-incident keyframes
    compact_ids: torch.Tensor
    compact_mask: torch.Tensor
    cam_pyr: CameraPyramid


def growth_points(device=None, sizes=GROWTH_SIZES, samples: int = SAMPLES):
    """bench_scaling.py's graphs, one per keyframe count in ``sizes``,
    drawn in turn from one generator seeded 0 -> yields GrowthPoint."""
    dev = resolve_device(device)
    h, w, cs, fs, levels = 64, 80, 16, 16, 4
    rng = np.random.default_rng(0)
    cam, pyr = synthetic._camera(h, w, levels)
    feat = rng.standard_normal((fs, h, w)).astype(np.float32) * 0.3
    window1 = synthetic._window(rng, feat, 1, h, w, cs, levels, samples, cam, pyr, dev)
    for k in sizes:
        window = _tile(window1, k)
        pairs, win_pairs, ids = growth_pairs(k)
        lo = k - GROWTH_WINDOW
        priors = synthetic._priors(k, dev)
        taus = (rng.standard_normal((k, 6)) * 0.01).astype(np.float32)
        variables = Variables(se3_exp(torch.from_numpy(taus).to(dev)), torch.zeros((k, cs), device=dev),
                              torch.ones(k, device=dev))
        umask = torch.zeros(k, device=dev)
        umask[lo:] = 1.0

        def problem(ps):
            table = synthetic._edges([p[0] for p in ps], [p[1] for p in ps], dev)
            return ba.BAProblem(window, table, table, priors)

        id_map = {kf: c for c, kf in enumerate(ids)}
        compact = ba.prepare_problem(problem([(id_map[a], id_map[b]) for a, b in win_pairs]), pyr)
        yield GrowthPoint(k, variables, umask, {"windowed": problem(win_pairs), "full": problem(pairs)},
                          compact, torch.tensor(ids, device=dev),
                          torch.tensor([1.0 if kf >= lo else 0.0 for kf in ids], device=dev), pyr)


def growth_curve(device=None, sizes=GROWTH_SIZES, reps: int = 5, samples: int = SAMPLES) -> list:
    """mapping_step_ms per keyframe count -> the printed records, each
    with the LM iterations of its steps (not printed)."""
    dev = resolve_device(device)
    cfg = MapperConfig()
    out = []
    for g in growth_points(dev, sizes, samples):
        v, pyr = g.variables, g.cam_pyr
        row, iters = {"metric": "mapping_step_ms", "keyframes": g.keyframes}, 0
        for name, problem in g.problems.items():
            ms, n = _time_step(lambda p=problem: ba.run_ba(v, p, pyr, cfg, g.update_mask, max_iters=1),
                               dev, reps)
            row[name], row[f"{name}_edges"] = round(ms, 2), 2 * problem.photo_edges.i0.shape[0]
            iters += n

        sel = g.compact_ids
        pad_valid = torch.ones(sel.shape[0], device=dev)

        def compact_step():
            compact = ba.compact_problem_keyframes(g.compact, sel, pad_valid, pyr)
            v_c = Variables(SE3(v.pose.rot[sel], v.pose.trans[sel]), v.code[sel], v.scale[sel])
            return ba.run_ba(v_c, compact, pyr, cfg, g.compact_mask, max_iters=1)

        ms, n = _time_step(compact_step, dev, reps)
        row["compact"], row["compact_keyframes"] = round(ms, 2), sel.shape[0]
        out.append(dict(emit(row), lm_iterations=iters + n))
    return out


def main(argv=None) -> dict:
    ap = parser(__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=None,
                    help="largest mesh (default: the cards present, or 1 with --device)")
    ap.add_argument("--cpu", type=int, default=None, metavar="N",
                    help="N gloo ranks on the CPU (--device cpu --ranks N)")
    ap.add_argument("--growth-max", type=int, default=GROWTH_SIZES[-1],
                    help="largest keyframe count of growth_curve (0: skip it)")
    args = ap.parse_args(argv)
    if args.cpu is not None:
        args.device, args.ranks = "cpu", args.cpu
    dev = resolve_device(args.device)
    start(dev, "scaling")
    if args.ranks is None:
        args.ranks = torch.cuda.device_count() if args.device is None else 1
    return {"scaling": scaling(args.ranks, args.device),
            "growth": growth_curve(dev, [k for k in GROWTH_SIZES if k <= args.growth_max])}


if __name__ == "__main__":
    main()
