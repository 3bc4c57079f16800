"""Roofline of the window-BA step on the card (port of bench_roofline.py).

    python -m sage_slam_tpu_torch.bench.roofline [--device cpu]

Measures in one run on one device:

1. the streaming rate: 1 GiB of float32 read and written to a second
   buffer per call (2 GiB moved, as bench_roofline.py counts it), the two
   buffers swapping roles so that every call reads the previous one's
   output;
2. the float32 matmul rate: chained 4096^3 products of a matrix with
   itself (entries 1/4096, a fixed point), in full float32 with TF32 off,
   the port's precision (bench_roofline.py used Precision.DEFAULT);
3. the scattered-row gather rate: 73,728 rows (24 edges x 3072 points) of
   196 float32 (784 B, the quad-packed feature+gradient row) from a
   40,960-row table, chained by rolling the index vector;
4. the window-BA step at the bench point (bench/global_ba.py), 1 and 10
   LM iterations;

and places the step against bench_roofline.py's model of one LM iteration
(``model``: the bytes its gathers move and the FLOPs of its reduces) and
the measured rates (``derive``: sol_* the least times, pct_* the step's
share of them). torch.matmul and index_select here probe the card; they
are not the port of a kernel. Prints the device line, then one JSON object
with bench_roofline.py's keys, the published peaks of the card beside them;
returns that object with ``lm_iterations`` (not printed), the LM iterations
of the BA steps, warm-up included.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..config import MapperConfig
from ..device import resolve_device
from . import card_line, emit, parser, peaks_for, start, sync
from .global_ba import bench_point, factors_per_second

MATMUL_PRECISION = ("float32 FMA, TF32 off (the port's precision; bench_roofline.py's "
                    "jax.lax.dot used Precision.DEFAULT)")


def time_chained(step, state, dev, reps: int = 20, warmup: int = 3) -> float:
    """Seconds per call of ``state -> state``, each call consuming the
    previous call's output, after ``warmup`` calls."""
    for _ in range(warmup):
        state = step(state)
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        state = step(state)
    sync(dev)
    return (time.perf_counter() - t0) / reps


def stream_rate(dev, nbytes: int) -> float:
    """GB/s of a read of ``nbytes`` of float32 and a write of as many."""
    a = torch.ones(nbytes // 4, dtype=torch.float32, device=dev)
    b = torch.empty_like(a)

    def step(s):
        src, dst = s
        torch.neg(src, out=dst)
        return dst, src

    dt = time_chained(step, (a, b), dev)
    return 2 * nbytes / dt / 1e9


def matmul_rate(dev, m: int) -> float:
    """TFLOP/s of chained m^3 float32 products."""
    a = torch.full((m, m), 1.0 / m, dtype=torch.float32, device=dev)
    dt = time_chained(lambda x: torch.matmul(x, x), a, dev)
    return 2 * m**3 / dt / 1e12


GATHER_ROWS, GATHER_WIDTH, GATHER_TABLE_ROWS = 24 * 3072, 196, 8 * 5120


def gather_rate(dev):
    """(ns per row, effective GB/s) of gathering GATHER_ROWS rows of
    GATHER_WIDTH float32 at indices from numpy.random.default_rng(0)."""
    table = torch.ones((GATHER_TABLE_ROWS, GATHER_WIDTH), dtype=torch.float32, device=dev)
    idx = torch.from_numpy(np.random.default_rng(0).integers(0, GATHER_TABLE_ROWS, size=GATHER_ROWS)).to(dev)

    def step(s):
        i, acc = s
        return torch.roll(i, 1), acc + torch.sum(table.index_select(0, i)) * 1e-12

    dt = time_chained(step, (idx, torch.zeros((), device=dev)), dev)
    return dt / GATHER_ROWS * 1e9, GATHER_ROWS * GATHER_WIDTH * 4 / dt / 1e9


def model(photo_edges: int = 24, geo_edges: int = 24, n: int = 3072, levels: int = 4, fs: int = 16,
          cs: int = 16) -> dict:
    """bench_roofline.py's model of one LM iteration: photometric rows
    gathered from the quad-packed table (4 corners x (3 FS + 1) floats), the
    geometric term's (1 + CS) floats per point on both frames, and the
    reduces' FLOPs (photometric J [L N FS, 13 + CS], geometric J [N, 14 + 2
    CS]) -> byte and FLOP counts."""
    photo_rows = photo_edges * n
    photo_bytes = photo_rows * 4 * (3 * fs + 1) * 4
    geo_bytes = geo_edges * n * (1 + cs) * 4 * 2
    dim, gdim = 13 + cs, 14 + 2 * cs
    flops = (photo_edges * 2 * levels * n * fs * (dim * dim + dim)
             + geo_edges * 2 * n * (gdim * gdim + gdim))
    return dict(photo_rows=photo_rows, photo_bytes=photo_bytes, geo_bytes=geo_bytes,
                gather_bytes=photo_bytes + geo_bytes, flops=flops)


def derive(rates: dict, m: dict, iter_ms: float) -> dict:
    """bench_roofline.py's derived numbers from the rates it measures
    (stream_GBps_rw, gather_ns_per_row, gather_effective_GBps,
    matmul_f32_TFLOPs; here unrounded), a model and the measured ms per LM
    iteration."""
    t_stream = m["gather_bytes"] / (rates["stream_GBps_rw"] * 1e9)
    t_gatherwall = (m["photo_rows"] * rates["gather_ns_per_row"] * 1e-9
                    + m["geo_bytes"] / (rates["gather_effective_GBps"] * 1e9))
    t_mxu = m["flops"] / (rates["matmul_f32_TFLOPs"] * 1e12)
    achieved = iter_ms * 1e-3
    return {
        "model_gather_MB_per_iter": round(m["gather_bytes"] / 1e6, 1),
        "model_reduce_GFLOP_per_iter": round(m["flops"] / 1e9, 2),
        "sol_streaming_ms": round(t_stream * 1e3, 3),
        "sol_gather_wall_ms": round(t_gatherwall * 1e3, 3),
        "sol_mxu_ms": round(t_mxu * 1e3, 3),
        "pct_of_gather_wall": round(100 * t_gatherwall / achieved, 1),
        "pct_of_streaming_roofline": round(100 * t_stream / achieved, 1),
        "mfu_pct": round(100 * t_mxu / achieved, 1),
    }


def run(dev, stream_bytes: int = 1 << 30, matmul: int = 4096, reps: int = 10,
        samples: int = 3072) -> dict:
    """Every measurement and the derived numbers -> the printed object,
    with ``lm_iterations``."""
    rates = {"stream_GBps_rw": stream_rate(dev, stream_bytes), "matmul_f32_TFLOPs": matmul_rate(dev, matmul)}
    ns_row, gbps = gather_rate(dev)
    rates.update(gather_ns_per_row=ns_row, gather_effective_GBps=gbps)
    out = {"backend": dev.type, "stream_GBps_rw": round(rates["stream_GBps_rw"], 1),
           "matmul_f32_TFLOPs": round(rates["matmul_f32_TFLOPs"], 1), "matmul_precision": MATMUL_PRECISION,
           "gather_ns_per_row": round(ns_row, 2), "gather_effective_GBps": round(gbps, 1)}

    variables, problem, pyr = bench_point(dev, samples)
    cfg = MapperConfig()
    fps1, iters1 = factors_per_second(variables, problem, pyr, cfg, 1, reps)
    fps10, iters10 = factors_per_second(variables, problem, pyr, cfg, cfg.max_gn_iters, reps)
    fps1, fps10 = round(fps1, 2), round(fps10, 2)
    out["factors_per_second_10iter"] = fps10
    out["factors_per_second_1iter"] = fps1
    factors = problem.photo_edges.i0.shape[0] + problem.geo_edges.i0.shape[0]
    step_ms = factors * cfg.max_gn_iters / fps10 * 1e3
    iter_ms = step_ms / cfg.max_gn_iters
    out["ba_step_ms_10iter"] = round(step_ms, 2)
    out["ba_iter_ms"] = round(iter_ms, 3)
    m = model(problem.photo_edges.i0.shape[0], problem.geo_edges.i0.shape[0], samples)
    out.update(derive(rates, m, iter_ms))
    if dev.type == "cuda":
        name, bw, flops = peaks_for(torch.cuda.get_device_name(dev))
        out.update({"card": card_line(), "peaks": f"{name} data sheet", "peak_hbm_GBps": bw / 1e9,
                    "peak_fp32_TFLOPs": flops / 1e12})
    return dict(emit(out), lm_iterations=iters1 + iters10)


def main(argv=None) -> dict:
    ap = parser(__doc__.splitlines()[0])
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    start(dev, "roofline")
    return run(dev)


if __name__ == "__main__":
    main()
