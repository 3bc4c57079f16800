"""The port's counterparts of the repo's measuring programs (bench.py,
bench_roofline.py, bench_frontend.py, bench_scaling.py; __graft_entry__.py
is sage_slam_tpu_torch/entry.py):

    python -m sage_slam_tpu_torch.bench.global_ba   # factors/s of the window-BA step
    python -m sage_slam_tpu_torch.bench.roofline    # card rates and the BA step's roofline
    python -m sage_slam_tpu_torch.bench.frontend    # ms per tracked frame on a Bowl3D orbit
    python -m sage_slam_tpu_torch.bench.scaling     # sharded factors/s, mapping ms vs keyframes

Each runs on the current CUDA device unless given ``--device cpu`` (and
raises without CUDA otherwise), prints first a line naming the device and,
on a card, its name and power limit as ``nvidia-smi --query-gpu=name,
power.limit --format=csv,noheader`` gives them, then the JAX program's JSON
lines with its metric names, keys and units. Times are host clock around
work that ends in a device synchronisation, after warm-up; variables are
chained through the timed steps as in the JAX programs.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

# Published peaks (NVIDIA data sheets) by card name: memory bytes/s, FP32
# FLOP/s outside the tensor cores
PEAKS = (
    ("H100 PCIe", 2.0e12, 51e12),
    ("H100 NVL", 3.9e12, 60e12),
    ("H100", 3.35e12, 67e12),  # SXM (HBM3), the default entry
    ("H200", 4.8e12, 67e12),
)


def peaks_for(name: str):
    """(PEAKS key, bytes/s, FP32 FLOP/s) of the card named ``name``; an
    unlisted card is taken as an H100 SXM and says so."""
    for key, bw, flops in PEAKS:
        if key in name:
            return key, bw, flops
    return "H100 (assumed)", 3.35e12, 67e12


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def emit(record: dict) -> dict:
    """Print one JSON line -> the record."""
    print(json.dumps(record), flush=True)
    return record


def start(dev: torch.device, program: str) -> dict:
    """The first line of every program: what it ran on."""
    return emit({"program": program, "device": str(dev),
                 "card": card_line() if dev.type == "cuda" else None})


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def parser(description: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device; 'cpu' on the CPU)")
    return ap

