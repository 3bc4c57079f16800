"""Fixtures of the benchmark's own tests (CPU, tiny sizes).

    python -m pytest benchmark/tests -q

These tests import neither JAX nor the repo's ``tests/conftest.py``. The
test marked ``cuda`` runs a cell on the card; it skips here, deciding inside
its fixture.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
SEED = 2**31 + 12345


def tiny_checkout(tmp: Path) -> Path:
    """A copy of BENCHMARK.json and benchmark/ whose configuration and
    traffic files are cut to a size the CPU runs in seconds: 64x80 input,
    256 photometric samples, a 16-keyframe store and a 5-keyframe map (the
    networks keep their widths)."""
    shutil.copytree(REPO / "benchmark", tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", tmp)
    for path in (tmp / "benchmark" / "configs").glob("*.json"):
        c = json.loads(path.read_text())
        c.update(net_input_size=[64, 80], net_output_size=[32, 40], max_keyframes=16)
        c["mapper"]["pho_num_samples"] = 256
        c["map_keyframes"] = 5
        path.write_text(json.dumps(c))
    lm = tmp / "benchmark" / "workloads" / "full_graph_lm.json"
    t = json.loads(lm.read_text())
    t["video"].update(height=64, width=80)
    t["trace_steps"] = 1
    lm.write_text(json.dumps(t))
    return tmp


@pytest.fixture(scope="module")
def tiny(tmp_path_factory) -> Path:
    return tiny_checkout(tmp_path_factory.mktemp("tiny"))


@pytest.fixture
def card():
    """The card, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")
