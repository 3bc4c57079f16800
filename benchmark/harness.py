"""What every run shares: the manifest and the files it names, the clock,
the card check, the guard against JAX, and the result line.

A cell (``workloads`` entry of BENCHMARK.json) names a configuration and a
traffic mix. The configuration's file is the ``file`` of its ``configs``
entry; the traffic mix is ``workloads/<traffic>.json`` and names its driver,
``drivers/<driver>.py``; a per-layer metric is ``metrics/<name>.py``. Each
is found by its name, so new cells, mixes and metrics are new files.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from types import ModuleType

BENCH_DIR = Path(__file__).resolve().parent
# packages no run may load, compared by whole top-level module names
FORBIDDEN = ("jax", "jaxlib", "flax", "sage_slam_tpu")

def now() -> float:
    """Seconds on the clock that process start times are read against."""
    return time.clock_gettime(time.CLOCK_BOOTTIME)

def process_start() -> float:
    """This process's start on ``now()``'s clock (/proc/self/stat field 22,
    in clock ticks since boot)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return int(fields[19]) / os.sysconf("SC_CLK_TCK")

def forbidden_modules(names=None) -> list:
    """The FORBIDDEN top-level names among ``names`` (default: the modules
    loaded in this process), each compared whole: ``sage_slam_tpu_torch``
    is not ``sage_slam_tpu``."""
    names = sys.modules if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))

def load_module(path: Path, name: str) -> ModuleType:
    """A Python file loaded by path (metric files carry dots in their
    names, so they are not importable as modules)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod

@dataclasses.dataclass
class Cell:
    """One cell and what its names resolve to."""

    name: str
    bench_dir: Path  # the benchmark's folder in the checkout
    chips: int
    config_name: str
    config_path: Path
    config: dict  # the configuration file
    traffic: dict  # workloads/<traffic>.json
    end_to_end: list  # the manifest's end_to_end entries this cell reports
    per_layer: list  # the manifest's per_layer entries this cell reports

    @property
    def driver_path(self) -> Path:
        return self.bench_dir / "drivers" / f"{self.traffic['driver']}.py"

    def driver(self) -> ModuleType:
        return load_module(self.driver_path, f"benchmark_driver_{self.traffic['driver']}")

    def readers(self) -> list:
        """(metric entry, reader module) for every per-layer metric."""
        return [(m, load_module(self.bench_dir / "metrics" / f"{m['name']}.py",
                                "benchmark_metric_" + m["name"].replace(".", "_")))
                for m in self.per_layer]

def load_manifest(root: Path) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)

def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]

def resolve(root: Path, workload: str) -> Cell:
    """The cell named ``workload`` with its files, from the manifest at
    ``root``; raises KeyError or FileNotFoundError naming what is missing."""
    manifest = load_manifest(root)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    cfg_entry = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    cfg_path = root / cfg_entry["file"]
    with open(cfg_path) as f:
        config = json.load(f)
    bench_dir = root / BENCH_DIR.name
    with open(bench_dir / "workloads" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    e2e = [m for m in manifest["end_to_end"] if _reports(m, workload)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"]
             if (workload in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    return Cell(workload, bench_dir, int(w["chips"]), w["config"], cfg_path, config, traffic, e2e,
                layer)

def result(correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
           checks: list, breakdown: dict | None = None) -> dict:
    """The result line's object; the compared numbers come last."""
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    return out
