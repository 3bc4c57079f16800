"""Where the time of one window-BA step goes on the GPU.

    python -m sage_slam_tpu_torch.profile_ba [--trace DIR] [--iters 10]

Builds the bench problem (synthetic.bench_problem: K=8, 64x80, CS=FS=16,
L=4, N=3072, 24+24 edges) on the card, warms up, then reports:

* host-clock ms of one run_ba step, one linearize and one total_error
  (each ending in torch.cuda.synchronize()), means of 5 after warm-up;
* a torch.profiler trace of one run_ba step: the device time summed by
  kernel name (top 15, then the port's photo_reduce kernels wherever they
  rank), the summed device time against the step's wall
  time (the device busy share; kernels that overlap count twice, so this
  is an upper bound), and the number of kernel launches.

With ``--trace DIR`` the Chrome trace is written there. Needs a CUDA
device; prints the card's name and power limit first.
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", default=None, help="directory for the Chrome trace")
    ap.add_argument("--iters", type=int, default=10, help="LM iterations per step")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_ba needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from .config import MapperConfig
    from .solver import ba
    from .synthetic import bench_problem

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"card: {card}", flush=True)
    cfg = MapperConfig()
    variables, problem, pyr = bench_problem()
    problem = ba.prepare_problem(problem, pyr)
    mask = torch.ones(variables.num_kf, device=variables.scale.device)

    def step():
        return ba.run_ba(variables, problem, pyr, cfg, mask, max_iters=args.iters)

    for label, fn in (
        (f"run_ba step ({args.iters} iterations)", step),
        ("linearize", lambda: ba.linearize(variables, problem, pyr, cfg)),
        ("total_error", lambda: ba.total_error(variables, problem, pyr, cfg)),
    ):
        mean, runs = _host_ms(fn)
        print(f"host ms [{card}] {label}: {mean:.3f} (runs "
              f"{', '.join(f'{r:.3f}' for r in runs)})", flush=True)

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if getattr(e, "device_type", None)
              == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in events)
    launches = sum(e.count for e in events)
    print(f"profiled run_ba step [{card}]: wall {wall_ms:.3f} ms, device time "
          f"{device_us / 1e3:.3f} ms summed over {launches} kernel launches, busy "
          f"share <= {device_us / 1e3 / wall_ms:.4f}", flush=True)
    ranked = sorted(events, key=lambda e: -e.self_device_time_total)
    # the top 15, then the port's own kernels wherever they rank
    for e in ranked[:15] + [e for e in ranked[15:] if "photo_reduce" in e.key]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")
    if args.trace:
        os.makedirs(args.trace, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.trace, "run_ba_step.json"))


if __name__ == "__main__":
    main()
