"""The manifest against the contract's shapes, name lookup, a cell added as
files only, the import guard, and a run without a card."""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from benchmark import harness

from .conftest import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def manifest():
    return harness.load_manifest(REPO)


def test_manifest_keys_names_and_units():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert 1 <= m["run_seconds"] <= 51
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer") for x in m[key]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for metric in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
    for metric in m["end_to_end"]:
        assert 0.01 <= metric["bound"] <= 0.25 and metric["source"] in ("host_clock", "device_trace")
    e2e = {x["name"] for x in m["end_to_end"]}
    for metric in m["per_layer"]:
        assert metric["moves"] in e2e
        assert 1 <= len(metric["layer"]) <= 200 and "\n" not in metric["layer"]
    for w in m["workloads"]:
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        cell = harness.resolve(REPO, w["name"])
        reported = {x["name"] for x in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer


@pytest.mark.parametrize("cell", [w["name"] for w in manifest()["workloads"]])
def test_every_name_resolves_to_its_files(cell):
    c = harness.resolve(REPO, cell)
    assert c.config_path.is_file() and c.driver_path.is_file()
    assert c.config["name"] == c.config_name and "source" in c.config and "reduced" in c.config
    assert hasattr(c.driver(), "run")
    for entry, reader in c.readers():
        assert callable(reader.read), entry["name"]
        assert reader.read({}) is None, entry["name"]


def test_command_names_only_files_under_paths():
    m = manifest()
    assert m["command"][:2] == ["python3", "-m"]
    module = m["command"][2]
    assert (REPO / (module.replace(".", "/") + ".py")).is_file()
    assert module.split(".")[0] in m["paths"]


def test_an_added_cell_is_found_from_new_files_only(tmp_path):
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    before = {p: p.read_bytes() for p in (tmp_path / "benchmark").rglob("*") if p.is_file()}
    bench = tmp_path / "benchmark"
    cfg = json.loads((bench / "configs" / "refine_map64.json").read_text())
    cfg.update(name="refine_map128", map_keyframes=128)
    (bench / "configs" / "refine_map128.json").write_text(json.dumps(cfg))
    traffic = json.loads((bench / "workloads" / "full_graph_lm.json").read_text())
    traffic["connections"] = 4
    (bench / "workloads" / "full_graph_lm4.json").write_text(json.dumps(traffic))
    (bench / "metrics" / "lm_iters.factors.py").write_text(
        "def read(ctx):\n    return ctx.get('lm_iters')\n")
    m = json.loads((tmp_path / "BENCHMARK.json").read_text())
    m["configs"].append(dict(m["configs"][0], name="refine_map128",
                             file="benchmark/configs/refine_map128.json"))
    m["workloads"].append({"name": "refine_map128.full_graph_lm4", "config": "refine_map128",
                           "traffic": "full_graph_lm4", "chips": 1, "why": "a test cell"})
    m["per_layer"].append({"name": "lm_iters.factors", "unit": "iters", "better": "higher",
                           "source": "program_counter", "layer": "LM step",
                           "moves": "global_ba_factors_per_s",
                           "workloads": ["refine_map128.full_graph_lm4"]})
    next(e for e in m["end_to_end"] if e["name"] == "global_ba_factors_per_s")["workloads"].append(
        "refine_map128.full_graph_lm4")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))

    cell = harness.resolve(tmp_path, "refine_map128.full_graph_lm4")
    assert cell.config["map_keyframes"] == 128 and cell.traffic["connections"] == 4
    assert cell.driver_path == bench / "drivers" / "full_graph_lm.py"
    readers = dict((e["name"], r) for e, r in cell.readers())
    assert readers["lm_iters.factors"].read({"lm_iters": 7}) == 7
    assert {m["name"] for m in cell.end_to_end} == {"global_ba_factors_per_s", "setup_s"}
    after = {p: p.read_bytes() for p in before}
    assert after == before


@pytest.mark.parametrize("names, found", [
    (["sage_slam_tpu_torch", "sage_slam_tpu_torch.solver.ba", "numpy", "torch"], []),
    (["jax.numpy", "torch"], ["jax"]),
    (["jaxlib.xla_client"], ["jaxlib"]),
    (["flax.linen"], ["flax"]),
    (["sage_slam_tpu.ops.photometric", "sage_slam_tpu_torch"], ["sage_slam_tpu"]),
    (["jaxtyping", "flaxen", "sage_slam_tpu_torchvision"], []),
])
def test_import_guard_matches_whole_top_level_names(names, found):
    assert harness.forbidden_modules(names) == found


def test_reference_and_harness_import_no_jax_and_reference_no_program():
    code = ("import sys; import benchmark.run, benchmark.calibrate, "
            "benchmark.reference.refine; from benchmark import harness; "
            "ref = sorted({m.split('.')[0] for m in sys.modules} & {'sage_slam_tpu_torch'}); "
            "print(harness.forbidden_modules(), ref)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[] []"


def test_a_run_without_a_card_fails_and_prints_no_result(tmp_path):
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    for root in (REPO, tmp_path):
        out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                              "refine_map64.full_graph_lm", "--seed", str(2**31 + 7), "--seconds", "1",
                              "--trace", "0"], cwd=root, capture_output=True, text=True,
                             timeout=120, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
        assert out.returncode != 0
        assert '"correct"' not in out.stdout
