"""Factor throughput (factors/s) of the window-BA step (port of bench.py).

    python -m sage_slam_tpu_torch.bench.global_ba [--device cpu]

At the bench point (synthetic.bench_problem: K=8, 64x80, CS=FS=16, L=4,
N=3072 samples, 24 photometric + 24 geometric ring edges) one step is
ba.run_ba over LM iterations that each linearize every factor once (K1
launched once per iteration on the card). The window's gather tables are
built by ba.prepare_problem outside the timed region, as production builds
them once per keyframe. Each measurement warms up with one step, then
chains the variables through ``reps`` (10) steps and synchronises once.

Prints, after the device line, bench.py's two lines:
``factors_per_second_global_ba_1iter`` (1 LM iteration per step) and
``factors_per_second_global_ba`` (10, MapperConfig.max_gn_iters), each
``{"metric", "value", "unit": "factors/s", "vs_baseline"}``. vs_baseline
divides by the reference's nominal 24 factors/s (its mapping backend's
2 Hz x 12 factors, from the reference's flags, as bench.py says): a
nominal rate of the reference system, not a measurement on any device.
The records returned (not printed) also carry ``lm_iterations``, the LM
iterations their steps ran, warm-up included.
"""

from __future__ import annotations

import time

import torch

from .. import synthetic
from ..config import MapperConfig
from ..device import resolve_device
from ..solver import ba
from . import emit, parser, start, sync

BASELINE = 24.0  # the reference's 2 Hz mapping x ~12 factors (bench.py's docstring)


def bench_point(device=None, samples: int = 3072):
    """bench.py's problem with its gather tables built -> (variables,
    prepared problem, cam_pyr)."""
    variables, problem, pyr = synthetic.bench_problem(device=device, n=samples)
    problem = ba.prepare_problem(problem, pyr)
    sync(variables.code.device)
    return variables, problem, pyr


def factors_per_second(variables, problem, pyr, cfg, lm_iters: int, reps: int):
    """Steps of run_ba(max_iters=lm_iters) chained through ``reps`` calls
    after one warm-up -> (factors linearized per second, counting every
    LM iteration as one linearization of every photometric and geometric
    factor, as bench.py does; the LM iterations that every call ran)."""
    dev = variables.code.device
    update_mask = torch.ones(variables.num_kf, device=dev)

    def step(v):
        return ba.run_ba(v, problem, pyr, cfg, update_mask, max_iters=lm_iters)

    iters = step(variables)[2]
    sync(dev)
    v = variables
    t0 = time.perf_counter()
    for _ in range(reps):
        v, _, n, _ = step(v)
        iters += n
    sync(dev)
    dt = (time.perf_counter() - t0) / reps
    factors = problem.photo_edges.i0.shape[0] + problem.geo_edges.i0.shape[0]
    return factors * lm_iters / dt, iters


def run(dev, reps: int = 10, samples: int = 3072) -> list:
    """Both of bench.py's measurements -> the printed records, each with
    its ``lm_iterations``."""
    variables, problem, pyr = bench_point(dev, samples)
    cfg = MapperConfig()
    out = []
    for metric, lm_iters in (("factors_per_second_global_ba_1iter", 1),
                             ("factors_per_second_global_ba", cfg.max_gn_iters)):
        fps, iters = factors_per_second(variables, problem, pyr, cfg, lm_iters, reps)
        rec = emit({"metric": metric, "value": round(fps, 2), "unit": "factors/s",
                    "vs_baseline": round(fps / BASELINE, 2)})
        out.append(dict(rec, lm_iterations=iters))
    return out


def main(argv=None) -> list:
    ap = parser(__doc__.splitlines()[0])
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    start(dev, "global_ba")
    return run(dev)


if __name__ == "__main__":
    main()
