"""The port's demo/make_eval chain, run small on the CPU, against the JAX
package.

The chain runs once per module through make_eval.run at 64x80 input /
32x40 output (the 4-level pyramid's coarsest level is then 4x5), a narrow
depth network (the feature network keeps FeatureNetConfig(), since
voc_builder builds that architecture to load the checkpoint, as in JAX),
1 epoch on 4 triplets from 12-frame training orbits, and a 6-frame eval
orbit, with ``--device cpu``. It writes the files and the report keys of
the JAX package's recorded artifact (eval_artifacts/). Step 1's triplets
equal JAX's ArraySequenceDataset samples; the evaluation and mesh steps
on the run directory equal JAX's own ate and tsdf functions called as the
JAX make_eval calls them (make_eval.py:209-288): ATE and depth RMSE to
1e-6 relative, the volumes voxel by voxel (at most 0.1% differing), the
vertices within 1e-5 of their JAX counterparts away from a differing voxel
(0.1% of them may read more, see the test), and equal vertex and face
counts and faces where no voxel differs."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sage_slam_tpu.eval import ate as jate
from sage_slam_tpu.eval import tsdf as jtsdf
from sage_slam_tpu.geometry.se3 import SE3 as JSE3
from sage_slam_tpu.io import tum_io as jtum
from sage_slam_tpu.io.dataset import Bowl3DInterface as JBowl3D
from sage_slam_tpu.training import dataset as jds
from sage_slam_tpu_torch.demo import make_eval
from sage_slam_tpu_torch.models import depth_network as tdn
from tests.test_torch_training import _same_triplet

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IN_HW, OUT_HW = (64, 80), (32, 40)
DEPTH = tdn.DepthNetConfig(filter_list=(4, 8, 16), bottleneck=16, bias_inner=(8, 1),
                           basis_inner=((8, 16),))
ARGS = ["--epochs", "1", "--train_triplets", "4", "--train_frames", "12", "--eval_frames", "6",
        "--max_keyframes", "8", "--separate_only", "--device", "cpu"]


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("make_eval"))
    report, system = make_eval.run(["--out_dir", out, *ARGS], depth_cfg=DEPTH, in_hw=IN_HW,
                                   out_hw=OUT_HW)
    return out, report, system


def _keys(tree):
    """The nested key structure of a report (dicts only)."""
    return {k: _keys(v) if isinstance(v, dict) else None for k, v in tree.items()}


def test_chain_writes_the_files_and_report_of_the_jax_artifact(chain):
    out, report, system = chain
    ref = os.path.join(ROOT, "eval_artifacts")
    # the trained networks' npz files are git-ignored in the JAX artifact
    want = set(os.listdir(ref)) | {"net_depth.npz", "net_feat.npz", "net_disc.npz"}
    assert set(os.listdir(out)) == want
    n = system.store.num_active
    run_files = set(os.listdir(os.path.join(out, "slam_run")))
    ref_run = {f for f in os.listdir(os.path.join(ref, "slam_run")) if not f.startswith("kf_")}
    assert run_files == ref_run | {f"kf_{i:04d}_depth.npy" for i in range(n)}
    assert sorted(os.listdir(os.path.join(out, "fly_through"))) == [f"fly_{i:02d}.png" for i in range(8)]

    with open(os.path.join(ref, "report.json")) as f:
        ref_report = json.load(f)
    with open(os.path.join(out, "report.json")) as f:
        written = json.load(f)
    assert _keys(written) == _keys(ref_report) == _keys(report)
    assert written["operating_point"] == dict(
        net_input=list(IN_HW), net_output=list(OUT_HW), code_size=16, feat_size=16,
        pho_num_samples=3072, pyramid_levels=4, backend="cpu",
    )
    assert written["slam"]["keyframes"] == written["depth"]["keyframes"] == n >= 2
    assert written["ate"]["frames"] == 6
    md = open(os.path.join(out, "EVAL.md")).read()
    assert "Backend: **cpu**" in md and "python -m sage_slam_tpu_torch.demo.make_eval" in md
    # the exported networks load as the demo loads them
    from sage_slam_tpu_torch.training.export import load_net_configs

    d_cfg, f_cfg = load_net_configs(os.path.join(out, "net_netcfg.json"))
    assert tuple(d_cfg.filter_list) == DEPTH.filter_list and f_cfg.mode == "unet"


def test_step1_triplets_equal_jax():
    """make_eval.py:78-101 with JAX's ArraySequenceDataset at the same
    widths against the port's build_triplets."""
    cfg_t = jds.TripletConfig(num_keypoints=128, frame_interval=3, far_frame_interval=10,
                              use_rotation_aug=False)
    jtrip = []
    for si, tb in enumerate(make_eval.training_orbits(12, IN_HW)):
        src = jds.ArraySequenceDataset(JBowl3D(**tb).to_arrays(), cfg=cfg_t, out_hw=OUT_HW,
                                       in_hw=IN_HW, seed=si)
        jtrip += [src.sample() for _ in range(2)]
    jtrip = [t for pair in zip(jtrip[:2], jtrip[2:]) for t in pair]
    ttrip = make_eval.build_triplets(12, 4, IN_HW, OUT_HW)
    assert len(ttrip) == len(jtrip) == 4
    for t, j in zip(ttrip, jtrip):
        _same_triplet(t, j)


def _jax_evaluate(run_dir, eval_bowl):
    """make_eval.py:209-288 with the JAX package's functions."""
    h_out, w_out = OUT_HW
    data = JBowl3D(**eval_bowl)
    traj = jtum.read_tum(os.path.join(run_dir, "trajectory.txt"))
    est = np.stack([t for _, t, _ in traj])
    gt = np.stack([data.pose_at(i)[:3, 3] for i in range(len(traj))])
    out = dict(sim3=jate.ate_rmse(est, gt, align="sim3"), se3=jate.ate_rmse(est, gt, align="se3"))
    kf_traj = jtum.read_tum(os.path.join(run_dir, "keyframe_trajectory.txt"))
    kf_est = np.stack([t for _, t, _ in kf_traj])
    kf_gt = np.stack([data.pose_at(int(ts))[:3, 3] for ts, _, _ in kf_traj])
    out["kf_sim3"] = jate.ate_rmse(kf_est, kf_gt, align="sim3")
    mask = data.mask(h_out, w_out)
    rmses, kf_depths, kf_poses = [], [], []
    for i, (ts, trans, rot) in enumerate(kf_traj):
        est_d = np.load(os.path.join(run_dir, f"kf_{i:04d}_depth.npy"))
        _, gt_d, _ = data.render(int(ts), h_out, w_out)
        rmses.append(jate.depth_rmse(est_d, gt_d, mask, align_scale=True))
        kf_depths.append(est_d)
        kf_poses.append((rot, trans))
    out["rmses"] = rmses
    cam = data.intrinsics().resized(w_out, h_out)
    centers = np.stack([t for (_, t) in kf_poses])
    med = float(np.median(np.concatenate([d.reshape(-1) for d in kf_depths])))
    lo = centers.min(0) - 0.5 * med
    hi = centers.max(0) + 2.0 * med
    dims = (96, 96, 96)
    vol = jtsdf.TSDFVolume.create(lo, dims, float(np.max(hi - lo) / max(dims)))
    step = jax.jit(lambda v, d, r, t: jtsdf.integrate(v, d, jnp.asarray(mask), JSE3(r, t), cam))
    for (rot, trans), d in zip(kf_poses, kf_depths):
        vol = step(vol, jnp.asarray(d), jnp.asarray(rot, jnp.float32), jnp.asarray(trans, jnp.float32))
    out["vol"] = vol
    out["mesh"] = jtsdf.marching_tetrahedra(vol)
    return out


def test_evaluate_and_mesh_steps_match_jax(chain, tmp_path):
    out, report, _ = chain
    run_dir = os.path.join(out, "slam_run")
    eval_bowl = make_eval.eval_orbit(6, IN_HW)
    ref = _jax_evaluate(run_dir, eval_bowl)
    ate, depth, kf = make_eval.evaluate(run_dir, eval_bowl, OUT_HW)
    assert ate == report["ate"] and depth == report["depth"]
    rtol = 1e-6
    for key, name in (("sim3_rmse", "sim3"), ("se3_rmse", "se3"), ("kf_sim3_rmse", "kf_sim3")):
        assert ate[key] == pytest.approx(round(float(ref[name]), 5), rel=rtol), key
    assert depth["mean_kf_rmse"] == pytest.approx(round(float(np.mean(ref["rmses"])), 5), rel=rtol)
    assert depth["max_kf_rmse"] == pytest.approx(round(float(np.max(ref["rmses"])), 5), rel=rtol)

    vol = make_eval.fuse(kf, device="cpu")
    jvol = ref["vol"]
    np.testing.assert_array_equal(vol.origin.numpy(), np.asarray(jvol.origin))
    assert (vol.voxel_size, vol.trunc) == (jvol.voxel_size, jvol.trunc)
    t, jt = vol.tsdf.numpy(), np.asarray(jvol.tsdf)
    differ = (np.abs(t - jt) > 1e-5) | (vol.weight.numpy() != np.asarray(jvol.weight))
    print(f"make_eval volume: {int(differ.sum())} of {t.size} voxels differ")
    assert differ.sum() <= 1e-3 * t.size

    mesh = make_eval.write_mesh(str(tmp_path), vol)
    assert mesh == {k: report["mesh"][k] for k in ("vertices", "faces", "path")}
    from scipy.spatial import cKDTree

    from sage_slam_tpu_torch.eval import tsdf

    # the weld keys vertices by position quantised to 1e-5 voxel, so the
    # volume's float32 roundoff may reorder them: vertices are matched to
    # their nearest counterpart. A voxel that differs (a flipped pixel)
    # moves the surface near it, so vertices within 2 voxels of one are
    # left out of the match and counted. The rest are held to 1e-5, but
    # for at most 0.1% of them: a vertex on a tetrahedron edge whose two
    # tsdf values nearly agree moves by edge * d / |v_b - v_a| for a tsdf
    # roundoff d (XLA and torch differ by up to ~1e-6 here), so one vertex
    # of 8088 read 1.2e-5 in one run (0 in three others); none may leave
    # its edge (sqrt(3) voxels)
    tverts, tfaces = tsdf.marching_tetrahedra(vol)
    verts, faces = ref["mesh"]
    flipped = np.argwhere(differ) * vol.voxel_size + vol.origin.numpy()

    def away(v):
        if not len(flipped):
            return np.ones(len(v), bool)
        return cKDTree(flipped).query(v)[0] > 2 * vol.voxel_size

    t_away, j_away = away(tverts), away(verts)
    dist, idx = cKDTree(verts).query(tverts[t_away])
    back = cKDTree(tverts).query(verts[j_away])[0]
    loose = int((dist > 1e-5).sum()), int((back > 1e-5).sum())
    print(f"mesh: {len(tverts)} / {len(verts)} vertices, {int((~t_away).sum())} / {int((~j_away).sum())} "
          f"near a differing voxel, {loose} beyond 1e-5 (max {dist.max():.3g})")
    assert max(loose) <= 1e-3 * len(verts)
    assert max(dist.max(), back.max()) <= np.sqrt(3) * vol.voxel_size
    if not differ.any():
        assert (len(tverts), len(tfaces)) == (len(verts), len(faces))
        assert len(np.unique(idx)) == len(verts)

        def canonical(f):
            """Each triangle rotated to start at its smallest index (keeps
            the orientation)."""
            roll = np.argmin(f, axis=1)
            return {tuple(np.roll(row, -r)) for row, r in zip(f, roll)}

        assert canonical(idx[tfaces]) == canonical(faces)


def test_error_budget_cli_loads_the_chains_networks_and_vocabulary(chain, tmp_path):
    """error_budget's CLI with the chain's exported checkpoints, network
    sidecar and vocabulary (the loaders run_slam uses): the F row (learned
    depth and features, loop ticks) over a 4-frame orbit, on the CPU."""
    from sage_slam_tpu_torch.eval import error_budget

    out, _, _ = chain
    path = str(tmp_path / "eb.json")
    report, systems = error_budget.run([
        "--device", "cpu", "--num_frames", "4", "--height", str(IN_HW[0]), "--width", str(IN_HW[1]),
        "--stages", "F_full_nets", "--out", path,
        "--depth_checkpoint", os.path.join(out, "net_depth.npz"),
        "--feat_checkpoint", os.path.join(out, "net_feat.npz"),
        "--net_config", os.path.join(out, "net_netcfg.json"),
        "--vocab_path", os.path.join(out, "bow_voc.npz"),
    ])
    row = report["F_full_nets"]
    with open(os.path.join(ROOT, "docs", "error_budget_r05.json")) as f:
        ref_keys = set(json.load(f)["D_full_oracle"])  # the JAX CLI's row keys
    # the keyframe ATE needs 3 keyframes, in JAX too
    assert set(row) == ref_keys - ({"kf_ate_sim3", "kf_ate_sim3_pct"} if row["keyframes"] < 3 else set())
    assert row["frames"] == 4 and row["keyframes"] >= 1
    assert np.isfinite([v for v in row.values() if isinstance(v, float)]).all()
    with open(path) as f:
        assert json.load(f) == report
    mapper = systems["F_full_nets"].mapper
    assert tuple(mapper.depth_net.cfg.filter_list) == DEPTH.filter_list
    assert mapper.feat_net.cfg.mode == "unet"
    saved = np.load(os.path.join(out, "net_feat.npz"))
    for name, p in mapper.feat_net.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), saved[name], err_msg=name)
    assert systems["F_full_nets"].voc is not None


@pytest.mark.parametrize("entry", ["make_eval", "error_budget", "gt_probe"])
def test_entry_points_raise_without_cuda(entry, monkeypatch, tmp_path):
    """Without --device, each new CLI asks for the card and raises where
    CUDA is absent, before it writes anything."""
    from sage_slam_tpu_torch.eval import error_budget, gt_probe

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mains = {"make_eval": (make_eval.main, ["--out_dir", str(tmp_path / "out")]),
             "error_budget": (error_budget.main, ["--out", str(tmp_path / "eb.json")]),
             "gt_probe": (gt_probe.main, ["--out", str(tmp_path / "gp.json")])}
    fn, argv = mains[entry]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fn(argv)
    assert not os.listdir(tmp_path)
