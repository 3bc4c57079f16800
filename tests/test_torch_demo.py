"""Port parity of the demo path: the CLIs (demo/run_slam, result_viewer,
voc_builder) and the perfect-prior ATE regression
(tests/test_torch_demo_driver.py holds the driver over prebuilt frames
and the headless viewers).

* run_slam.main on the CPU at tests/test_driver_demo.py's tiny config
  writes the files and summary keys JAX's CLI writes (config.json equal);
* result_viewer prints what JAX's prints on the same files;
* a JAX-written vocabulary npz reads to equal arrays, and the port's
  voc_builder writes one JAX reads to equal arrays;
* the port's counterpart of tests/test_ate_regression.py's
  test_ate_on_synthetic_lateral_motion meets its bounds (frame Sim3-ATE
  under 5.5% of the span, keyframe under 5.0%, keyframe depth RMSE under
  0.05) on the JAX test's inputs (JAX's sample draws,
  synthetic.PERFECT_PRIOR_DRAWS)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sage_slam_tpu.config import MapperConfig, SlamConfig, TrackerConfig
from sage_slam_tpu.demo import result_viewer as jviewer
from sage_slam_tpu.demo import run_slam as jrun
from sage_slam_tpu.demo import voc_builder as jvoc
from sage_slam_tpu.tracker import matcher as jmatcher
from sage_slam_tpu_torch import synthetic
from sage_slam_tpu_torch.demo import result_viewer as tviewer
from sage_slam_tpu_torch.demo import run_slam as trun
from sage_slam_tpu_torch.demo import voc_builder as tvoc

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN_FILES = {"config.json", "trajectory.txt", "trajectory_tracked.txt", "keyframe_trajectory.txt",
             "summary.json", "map.png"}


@pytest.fixture(scope="module")
def demo_runs(tmp_path_factory):
    """Both CLIs at test_demo_cli_synthetic's config, threadless, with
    --save_keyframes (the port's on --device cpu)."""
    tmp = tmp_path_factory.mktemp("demo")
    cfg = SlamConfig(
        net_input_size=(32, 32), net_output_size=(16, 16), code_size=4, feat_size=16,
        pyramid_levels=3, max_keyframes=8,
        tracker=TrackerConfig(max_num_iters=6, desc_num_keypoints=16),
        mapper=MapperConfig(pho_num_samples=32, desc_num_keypoints=16, max_gn_iters=2,
                            refine_mapping_iters=1),
    )
    cfg_path = str(tmp / "cfg.json")
    cfg.to_json(cfg_path)
    args = ["--source_url", "synthetic://", "--config", cfg_path, "--max_frames", "5", "--no_threads",
            "--save_keyframes"]
    out = {}
    for name, main, extra in (("jax", jrun.main, []), ("port", trun.main, ["--device", "cpu"])):
        log_dir = str(tmp / name)
        out[name] = (main(args + ["--run_log_dir", log_dir] + extra), log_dir)
    return out


def test_demo_cli_writes_what_jax_writes(demo_runs):
    (j_sum, j_dir), (t_sum, t_dir) = demo_runs["jax"], demo_runs["port"]
    assert sorted(t_sum) == sorted(j_sum)
    assert t_sum["frames"] == j_sum["frames"] == 5 and t_sum["backend"] == "cpu"
    assert json.load(open(os.path.join(t_dir, "summary.json"))) == t_sum
    for d, s in ((t_dir, t_sum), (j_dir, j_sum)):
        files = set(os.listdir(d))
        kf = {f"kf_{i:04d}_depth.npy" for i in range(s["keyframes"])}
        assert files == RUN_FILES | kf, (d, files)
    assert json.load(open(os.path.join(t_dir, "config.json"))) == json.load(
        open(os.path.join(j_dir, "config.json")))
    for name in ("trajectory.txt", "trajectory_tracked.txt"):
        lines = open(os.path.join(t_dir, name)).read().splitlines()
        assert len(lines) == 5 and all(len(ln.split()) == 8 for ln in lines)
    assert np.load(os.path.join(t_dir, "kf_0000_depth.npy")).shape == (16, 16)


def test_result_viewer_prints_what_jax_prints(demo_runs, tmp_path, capfd):
    (_, j_dir), (_, t_dir) = demo_runs["jax"], demo_runs["port"]
    traj, gt = os.path.join(t_dir, "trajectory.txt"), os.path.join(j_dir, "trajectory.txt")
    outs = []
    for main, tag in ((tviewer.main, "t"), (jviewer.main, "j")):
        capfd.readouterr()
        plot = str(tmp_path / f"{tag}.png")
        main([traj, "--ground_truth", gt, "--align", "se3", "--plot", plot])
        outs.append(capfd.readouterr().out.replace(plot, "PLOT"))
        assert os.path.getsize(plot) > 0
    assert outs[0] == outs[1]
    assert "ATE RMSE (se3)" in outs[0]


def test_vocabulary_files_cross_packages(tmp_path):
    """eval_artifacts/bow_voc.npz (JAX-written) reads to JAX's arrays; the
    port's voc_builder writes an npz in the same layout that JAX reads to
    the port's arrays."""
    path = os.path.join(ROOT, "eval_artifacts", "bow_voc.npz")
    t, j = tvoc.load_npz_vocabulary(path, device="cpu"), jvoc.load_npz_vocabulary(path)
    for f in ("children", "descriptors", "weights", "word_ids"):
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)), err_msg=f)
    assert (t.num_words, t.levels) == (j.num_words, j.levels)

    out = str(tmp_path / "voc.npz")
    tvoc.main(["--source_url", "synthetic://", "--output", out, "--k", "3", "--levels", "2",
               "--points_per_frame", "50", "--max_frames", "2", "--input_size", "32,32",
               "--device", "cpu"])
    mine, ref = np.load(out), np.load(path)
    assert sorted(mine.files) == sorted(ref.files)
    assert all(mine[k].dtype == ref[k].dtype for k in ref.files)
    t, j = tvoc.load_npz_vocabulary(out, device="cpu"), jvoc.load_npz_vocabulary(out)
    assert t.num_words == j.num_words > 0
    for f in ("children", "descriptors", "weights", "word_ids"):
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)), err_msg=f)


def jax_perfect_prior_draws(num_frames=10, capacity=12):
    """The JAX package's draws for perfect_prior_system: each frame's
    photometric ids (Mapper.build_frame's jax.random.permutation of the
    all-ones mask's 320 pixels, cut to 256) and each keyframe's match
    keypoints (tracker.matcher.select_keypoints from the keyframe's seed,
    frontend/slam.py's hash)."""
    valid = jnp.arange(16 * 20, dtype=jnp.int32)
    loc1d = [np.asarray(jnp.take(valid, jax.random.permutation(
        jax.random.key(int(float(f) * 1e6) & 0x7FFFFFFF), valid.shape[0])[:256])) for f in range(num_frames)]
    keypoints = [np.asarray(jmatcher.select_keypoints(jax.random.key((kf * 2654435761 + 1) & 0x7FFFFFFF), valid, 32))
                 for kf in range(capacity)]
    return np.stack(loc1d), np.stack(keypoints)


def test_perfect_prior_draws_are_jax_draws():
    loc1d, keypoints = jax_perfect_prior_draws()
    d = np.load(synthetic.PERFECT_PRIOR_DRAWS)
    np.testing.assert_array_equal(d["loc1d"], loc1d)
    np.testing.assert_array_equal(d["keypoints"], keypoints)


def test_ate_on_synthetic_lateral_motion():
    """test_ate_on_synthetic_lateral_motion's chain and bounds in the port,
    on the JAX test's inputs (its sample draws)."""
    system, data = synthetic.perfect_prior_system(device="cpu", draws=synthetic.PERFECT_PRIOR_DRAWS)
    r = synthetic.perfect_prior_run(system, data)
    print({k: v for k, v in r.items() if k != "tracking_lost"})
    assert not any(r["tracking_lost"])
    assert r["span"] > 0.1
    assert r["frame_sim3"] < 0.055 * r["span"], (r["frame_sim3"], r["span"])
    assert r["keyframe_sim3"] < 0.05 * r["span"], (r["keyframe_sim3"], r["span"])
    assert r["travel"] > 1e-3
    assert max(r["depth_rmse"]) < 0.05, r["depth_rmse"]


def test_perfect_prior_with_the_ports_own_draws():
    """The same chain on the port's own seeded draws: the keyframe ATE and
    depth bounds hold; the frame ATE is reported (over sampling draws it
    spreads across the 5.5% bound: PERF.md)."""
    system, data = synthetic.perfect_prior_system(device="cpu")
    r = synthetic.perfect_prior_run(system, data)
    print(f"own draws: frame Sim3-ATE {r['frame_sim3'] / r['span']:.4%} of the span, "
          f"keyframe {r['keyframe_sim3'] / r['span']:.4%}")
    assert not any(r["tracking_lost"])
    assert r["keyframe_sim3"] < 0.05 * r["span"]
    assert max(r["depth_rmse"]) < 0.05
