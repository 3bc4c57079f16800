"""Where the time of one photometric reduce call goes on the GPU.

    python -m sage_slam_tpu_torch.profile_reduce

Builds the kernel, makes random inputs from a numpy seed at the window-BA
bench shape (E=24, L=4, C=16, N=3072, dim=29) and reports, for 50 wrapper
calls after warm-up:

* the device time of each of the call's kernels (torch.profiler kernel
  durations), their sum per call, and that sum against the bytes bound;
* the CUDA-event time per call around the same calls, and the host time
  per call of enqueueing them (host clock, no synchronisation inside), so
  a wrapper whose host cost exceeds the kernel's shows as such;
* the split plan the wrapper chose, and ptxas's registers, shared memory
  and spills when this call compiled the kernel.

Needs a CUDA device; prints the card's name and power limit first.
"""

from __future__ import annotations

import subprocess
import time

import numpy as np
import torch

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
SHAPE = (24, 4, 16, 3072, 29)  # E, L, C, N, dim at the window-BA bench point
REPS = 50


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_reduce needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from . import _build
    from .ops import photo_reduce as pr

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"card: {card}", flush=True)
    for name, (secs, log) in _build.build(["photometric"]).items():
        print(f"build {name}: {secs:.2f} s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  ptxas {name}: {line.strip()}")
    e, lv, c, n, dim = SHAPE
    rng = np.random.default_rng(0)
    arrays = (
        rng.standard_normal((e, lv, 3 * c, n)),
        rng.standard_normal((e, lv, c, n)),
        rng.random((e, n)),
        rng.standard_normal((e, dim, n)),
        rng.standard_normal((e, dim, n)),
    )
    ins = [torch.from_numpy(a.astype(np.float32)).cuda() for a in arrays]
    weights = (10.0, 9.0, 8.0, 7.0)
    ratios = tuple((0.5**i, 0.5**i) for i in range(lv))

    def call():
        pr.photo_reduce(*ins, weights, ratios)

    for _ in range(5):
        call()
    torch.cuda.synchronize()
    slots = pr._slots(ins[0].device.index, pr.pad_for(dim))
    splits = pr.num_splits(n, e, slots)
    sizes = sorted({b - a for a, b in pr.split_ranges(n, splits)})
    print(f"plan: {slots} resident block slots, {splits} splits per edge, grid "
          f"{splits}x{e} = {splits * e} blocks, split sizes {sizes} points")

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            call()
        torch.cuda.synchronize()
    kernels = [ev for ev in prof.key_averages()
               if getattr(ev, "device_type", None) == torch.autograd.DeviceType.CUDA]
    total_ms = sum(ev.self_device_time_total for ev in kernels) / 1e3 / REPS
    for ev in kernels:
        print(f"  device {ev.self_device_time_total / 1e3 / REPS:.5f} ms per call "
              f"x{ev.count // REPS} {ev.key[:80]}")
    in_bytes = sum(t.numel() * 4 for t in ins)
    bound_ms = (in_bytes + 4 * e * (dim * dim + dim + 2)) / PEAK_BYTES_PER_S * 1e3
    print(f"device [{card}] {total_ms:.5f} ms per call at E={e} L={lv} C={c} N={n} "
          f"dim={dim}; bytes bound {bound_ms:.5f} ms ({bound_ms / total_ms:.1%} of it)")

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    t0 = time.perf_counter()
    for _ in range(REPS):
        call()
    host_ms = (time.perf_counter() - t0) * 1e3 / REPS
    stop.record()
    torch.cuda.synchronize()
    print(f"events [{card}] {start.elapsed_time(stop) / REPS:.5f} ms per call; host "
          f"enqueue {host_ms:.5f} ms per call (host clock, no sync)")


if __name__ == "__main__":
    main()
