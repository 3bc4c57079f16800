"""Run one cell of the benchmark and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds BENCHMARK.json and the program. The
run works on the card only: without CUDA, or with fewer cards than the
cell asks for, it exits 2 and prints no result. It prints the card's name
and power limit first, each compared number beside its limit as the last
lines on standard error, and as the last line on standard output one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device``, with ``--trace 1`` also ``breakdown``, and
last ``checks``. A run that finds ``jax``, ``jaxlib``, ``flax`` or the JAX
package loaded once its window has closed exits 3 without a result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

from benchmark import harness
from benchmark.reference import compare


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def measure(cell, seed: int, seconds: float, traced: bool, dev, t_start: float):
    """Drive the cell -> (result object, check lines, the driver's output)."""
    out = cell.driver().run(cell, seed, seconds, traced, dev, t_start)
    if traced:
        metrics = {}
        for entry, reader in cell.readers():
            value = reader.read(out["ctx"])
            if value is not None:
                metrics[entry["name"]] = {"value": float(value), "unit": entry["unit"]}
    else:
        measured = dict(out["e2e"], setup_s=out["setup_s"])
        metrics = {m["name"]: {"value": float(measured[m["name"]]), "unit": m["unit"]}
                   for m in cell.end_to_end}
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": _device_name(dev), "count": cell.chips,
              "memory_peak_bytes": int(out.get("memory_peak_bytes", 0))}
    breakdown = None
    if traced:
        t = out["traced"]
        device.update(busy_s=t.busy_s, window_s=t.window_s)
        breakdown = {"device_ops": t.top_ops(10), "idle_gaps": t.top_gaps(10)}
    checks = out["checks"]
    res = harness.result(compare.passes(checks), out["attempted"], out["failed"], metrics, device,
                         checks, breakdown)
    return res, checks, out


def _device_name(dev) -> str:
    import torch

    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def main(argv=None) -> int:
    t_start = harness.process_start()
    args = parse(argv)
    cell = harness.resolve(Path.cwd(), args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    print(json.dumps({"workload": cell.name, "seed": args.seed, "card": card_line()}), flush=True)
    res, checks, out = measure(cell, args.seed, args.seconds, bool(args.trace), dev, t_start)
    print(json.dumps({"setup_phases_s": out["setup_phases"], "window_s": out["window_s"],
                      "window_work": out["window_work"], "check_s": out.get("check_s")}),
          flush=True)
    found = harness.forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    if out.get("trace_retried"):
        print(f"profiled again once: {out['trace_retried']}", file=sys.stderr)
    for c in checks:
        print(f"check {c['name']} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
