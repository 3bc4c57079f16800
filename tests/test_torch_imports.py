"""The port imports neither JAX nor the JAX package.

Walks the AST of every module of sage_slam_tpu_torch/ and of chip_smoke.py
and fails on any import whose root module is exactly ``jax``, ``jaxlib``
or ``sage_slam_tpu`` (roots compare exactly, so ``sage_slam_tpu_torch``
passes), or is one of the repo's root programs that drive the JAX package
(bench*.py, __graft_entry__.py). Also checks that the CUDA build directory
is git-ignored."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "sage_slam_tpu"}
PORT_FILES = sorted((ROOT / "sage_slam_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _import_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_module_imports_no_jax(path):
    bad = [(line, root) for line, root in _import_roots(path) if root in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


SLICE_MODULES = [
    "models/partial_unet.py", "models/depth_network.py", "models/feature_network.py",
    "ops/depth.py", "ops/residuals.py", "ops/robust_loss.py", "ops/reprojection.py",
    "mapping/keyframe_store.py", "mapping/mapper.py", "solver/ba.py",
    "tracker/matcher.py", "tracker/robust.py", "convert.py", "synthetic.py",
    # the tracker and frontend slice
    "ops/match_geometry.py", "tracker/matching_geo.py", "tracker/tracker.py",
    "frontend/__init__.py", "frontend/slam.py", "profile_slam.py",
    # the loop-closure and driver slice
    "loop/__init__.py", "loop/vocabulary.py", "loop/pose_graph.py", "native/__init__.py",
    "utils/__init__.py", "utils/timing.py", "frontend/driver.py",
    # the IO, eval and demo slice
    "io/__init__.py", "io/tum_io.py", "io/dataset.py", "eval/__init__.py", "eval/ate.py",
    "training/__init__.py", "training/export.py", "mapping/serialize.py", "viz/__init__.py",
    "viz/visualizer.py", "viz/warp_display.py", "demo/__init__.py", "demo/run_slam.py",
    "demo/voc_builder.py", "demo/result_viewer.py",
    # the training slice
    "training/losses.py", "training/discriminator.py", "training/dataset.py",
    "training/diff_ba.py", "training/train.py", "ops/photo_reduce.py", "ops/photometric.py",
    "ops/geometric.py",
    # the card's kernel wrappers
    "ops/photo_prep.py", "ops/geo_linearize.py",
    # the dense and diagnostic eval slice
    "eval/tsdf.py", "eval/error_budget.py", "eval/gt_probe.py", "demo/make_eval.py",
    # the default-off paths and multi-device BA
    "geometry/interp.py", "solver/graph.py", "parallel/__init__.py", "parallel/launch.py",
    "parallel/sharded_ba.py", "parallel/sharded_store.py",
    # the measuring programs
    "bench/__init__.py", "bench/global_ba.py", "bench/roofline.py", "bench/frontend.py",
    "bench/scaling.py", "entry.py",
]

# the repo's root programs that drive the JAX package
ROOT_SCRIPTS = {"bench", "bench_frontend", "bench_roofline", "bench_scaling", "__graft_entry__"}


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_module_imports_no_root_script(path):
    bad = [(line, root) for line, root in _import_roots(path) if root in ROOT_SCRIPTS]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("rel", SLICE_MODULES)
def test_mapper_slice_module_is_guarded(rel):
    """Every module of the mapper, tracker / frontend, loop / driver, IO /
    eval / demo, training, dense / diagnostic eval, multi-device and
    measuring-program slices exists and is among the files the guards
    above walk."""
    assert ROOT / "sage_slam_tpu_torch" / rel in PORT_FILES


def test_guard_compares_roots_exactly(tmp_path):
    src = tmp_path / "m.py"
    src.write_text(
        "import sage_slam_tpu_torch.ops\nfrom sage_slam_tpu_torch import convert\n"
        "import jaxtyping\nfrom sage_slam_tpu.ops import geometric\nimport jax.numpy\n"
    )
    roots = [root for _, root in _import_roots(src) if root in FORBIDDEN]
    assert roots == ["sage_slam_tpu", "jax"]


def test_cuda_build_directory_is_ignored():
    from sage_slam_tpu_torch import _build

    rel = _build.BUILD_DIR.relative_to(ROOT).as_posix()
    lines = {ln.strip().rstrip("/") for ln in (ROOT / ".gitignore").read_text().splitlines()}
    assert rel in lines, f"{rel}/ is not listed in .gitignore"
    assert _build.CSRC_DIR.is_dir() and all(
        (_build.CSRC_DIR / src).is_file() for srcs in _build.SOURCES.values() for src in srcs
    )


def test_native_runtime_source_is_the_ports_own():
    """The port's native loader builds its own copy of pipeline.cpp into the
    git-ignored build directory: its module names no path under
    sage_slam_tpu/native/ and imports nothing from there."""
    from sage_slam_tpu_torch import _build, native

    src = (ROOT / "sage_slam_tpu_torch" / "native" / "__init__.py").read_text()
    assert "sage_slam_tpu/native" not in src and "sage_slam_tpu.native" not in src
    assert native.SOURCE.parent == ROOT / "sage_slam_tpu_torch" / "native"
    assert native.SOURCE.is_file() and native.library_path().parent == _build.BUILD_DIR
