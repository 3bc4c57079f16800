"""The readings that the limits of ``correct`` are set from.

    python3 -m benchmark.calibrate --workload <cell> --seeds <n,n,...> --seconds <s>

For each seed, one run of the cell (a short window, no trace) gives the
program's numbers against the reference, and the control (the cell's
driver's ``control``: for the BA cell, the reference recomputed in the
precision below the configuration's) gives the same numbers against the
reference. Prints one JSON line per seed. The benchmark's own runs never
run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from benchmark import harness
from benchmark import run as brun


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    cell = harness.resolve(Path.cwd(), args.workload)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    driver = cell.driver()
    for seed in (int(s) for s in args.seeds.split(",")):
        res, checks, out = brun.measure(cell, seed, args.seconds, False, dev, harness.now())
        ctrl = driver.control(out)
        print(json.dumps({"seed": seed, "correct": res["correct"],
                          "program": {c["name"]: c["value"] for c in checks},
                          "control": {c["name"]: c["value"] for c in ctrl},
                          "metrics": {k: v["value"] for k, v in res["metrics"].items()}}), flush=True)
        del out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
