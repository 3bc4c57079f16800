"""The cell whose map fills the keyframe store, on the CPU at a tiny size:
``refine_map256``'s file with its ``map_keyframes`` set to the tiny
checkout's cut ``max_keyframes`` (16 keyframes at 64x80 input and 256
samples) and its ``schur_min_keyframes`` cut with it, so that its solver
``"auto"`` takes the Schur path there as it does at 256, runs through the
cell's program and is correct against the reference on seeded random
weights; one keyframe past the store's capacity is refused while the map
is built."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark import harness
from benchmark import run as brun
from sage_slam_tpu_torch.solver import graph

from .conftest import SEED, tiny_checkout

CELL = "refine_map256.full_graph_lm"


@pytest.fixture(scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def checkout(tmp, extra=0):
    """The tiny checkout with refine_map256's map set to its store's
    capacity plus ``extra`` keyframes and the Schur threshold to the
    capacity -> (root, map keyframes)."""
    root = tiny_checkout(tmp)
    path = root / "benchmark" / "configs" / "refine_map256.json"
    c = json.loads(path.read_text())
    assert c["mapper"]["solver"] == "auto"
    c["map_keyframes"] = c["max_keyframes"] + extra
    c["mapper"]["schur_min_keyframes"] = c["max_keyframes"]
    path.write_text(json.dumps(c))
    return root, c["map_keyframes"]


def test_a_map_that_fills_its_store_is_correct(tmp_path, one_thread, monkeypatch):
    root, k = checkout(tmp_path)
    cell = harness.resolve(root, CELL)
    assert k == cell.config["max_keyframes"] == 16
    widths = []
    schur_solve = graph.schur_solve

    def spy(h, b, num_kf, block_dim):
        widths.append(h.shape[-1])
        return schur_solve(h, b, num_kf, block_dim)

    monkeypatch.setattr(graph, "schur_solve", spy)
    res, checks, out = brun.measure(cell, SEED, 0.5, False, torch.device("cpu"), harness.now())
    assert res["correct"], checks
    assert widths and set(widths) == {k * (7 + cell.config["code_size"])}
    shapes = out["ctx"]["shapes"]
    assert shapes["num_kf"] == k
    assert shapes["e_photo"] == shapes["e_geo"] == 2 * (1 + 2 + 3 * (k - 3))
    assert res["failed"] == 0 and res["attempted"] >= 1


def test_a_keyframe_past_the_capacity_is_refused(tmp_path, one_thread):
    root, _ = checkout(tmp_path, extra=1)
    cell = harness.resolve(root, CELL)
    with pytest.raises(RuntimeError, match="keyframe store capacity exceeded"):
        brun.measure(cell, SEED, 0.5, False, torch.device("cpu"), harness.now())
