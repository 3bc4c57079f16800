"""Port parity of trajectory IO, ATE and the network-config loader:
sage_slam_tpu_torch.io.tum_io, .eval.ate and .training.export against the
JAX package's modules on the same inputs (numpy, float64).

Tolerances: every float result equal to float64 roundoff (rtol 1e-12,
atol 1e-15); files written by write_tum byte-identical."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sage_slam_tpu.eval import ate as jate
from sage_slam_tpu.geometry.se3 import se3_exp as jse3_exp
from sage_slam_tpu.io import tum_io as jtum
from sage_slam_tpu.training import export as jexport
from sage_slam_tpu_torch.eval import ate as tate
from sage_slam_tpu_torch.geometry.se3 import SE3
from sage_slam_tpu_torch.io import tum_io as ttum
from sage_slam_tpu_torch.training import export as texport

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-12, 1e-15


def _rot(axis, angle):
    axis = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * (k @ k)


def rotations():
    """Random rotations, the identity, and rotations at and near 180 degrees
    about each axis and random axes (every branch of the quaternion
    extraction)."""
    rng = np.random.default_rng(3)
    out = [np.eye(3)]
    for _ in range(12):
        out.append(_rot(rng.standard_normal(3), rng.uniform(0, np.pi)))
    for axis in ([1, 0, 0], [0, 1, 0], [0, 0, 1], rng.standard_normal(3), rng.standard_normal(3)):
        for angle in (np.pi, np.pi - 1e-6, np.pi - 1e-3, 3.0):
            out.append(_rot(axis, angle))
    return out


@pytest.mark.parametrize("i", range(len(rotations())))
def test_quaternion_round_trip_matches_jax(i):
    rot = rotations()[i]
    q_t, q_j = ttum.rotation_to_quaternion(rot), jtum.rotation_to_quaternion(rot)
    np.testing.assert_allclose(q_t, q_j, rtol=RTOL, atol=ATOL)
    assert q_t[3] >= 0
    np.testing.assert_allclose(ttum.quaternion_to_rotation(q_t), jtum.quaternion_to_rotation(q_j),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ttum.quaternion_to_rotation(q_t), rot, atol=1e-9)


def test_write_tum_files_are_byte_identical(tmp_path):
    """The same float32 poses through both packages' write_tum give the same
    bytes; read_tum reads them back to equal values in both."""
    rng = np.random.default_rng(0)
    taus = (rng.standard_normal((9, 6)) * 0.7).astype(np.float32)
    taus[4, 3:] = [np.pi - 1e-3, 0.0, 0.0]  # near 180 degrees
    jposes = [jse3_exp(jnp.asarray(t)) for t in taus]
    ts = [0.1 * i + 1e-7 * i * i for i in range(len(taus))]
    tpath, jpath = tmp_path / "t.txt", tmp_path / "j.txt"
    ttum.write_tum(str(tpath), [
        (t, SE3(torch.from_numpy(np.asarray(p.rot)), torch.from_numpy(np.asarray(p.trans))))
        for t, p in zip(ts, jposes)])
    jtum.write_tum(str(jpath), list(zip(ts, jposes)))
    assert tpath.read_bytes() == jpath.read_bytes()
    for (t0, p0, r0), (t1, p1, r1) in zip(ttum.read_tum(str(tpath)), jtum.read_tum(str(jpath))):
        assert t0 == t1
        np.testing.assert_array_equal(p0, p1)
        np.testing.assert_allclose(r0, r1, rtol=RTOL, atol=ATOL)
    ttum.write_tum(str(tpath), [])
    assert tpath.read_bytes() == b""


def test_read_tum_skips_comments_like_jax(tmp_path):
    path = tmp_path / "c.txt"
    path.write_text("# ts tx ty tz qx qy qz qw\n\n1.5 1 2 3 0 0 0 2 7\n2.0 0 0 0 0.5 0.5 0.5 0.5\n")
    a, b = ttum.read_tum(str(path)), jtum.read_tum(str(path))
    assert len(a) == len(b) == 2
    for (t0, p0, r0), (t1, p1, r1) in zip(a, b):
        assert t0 == t1
        np.testing.assert_array_equal(p0, p1)
        np.testing.assert_allclose(r0, r1, rtol=RTOL, atol=ATOL)


def _sim3_cases():
    """tests/test_eval.py's and test_ate_rmse_identity's inputs, plus
    random similarity transforms with near-180-degree rotations and noise."""
    rng = np.random.default_rng(0)
    gt = rng.uniform(-2, 2, (30, 3))
    p = jse3_exp(jnp.asarray([0.3, -0.2, 0.5, 0.2, -0.4, 0.3], jnp.float32))
    rot, t = np.array(p.rot, np.float64), np.array(p.trans, np.float64)
    cases = [((gt - t) @ rot / 1.7, gt)]
    rng = np.random.default_rng(0)
    gt2 = rng.standard_normal((20, 3))
    ang = 0.3
    rz = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1]])
    cases.append(((gt2 @ rz.T) * 2.0 + np.array([1.0, -2.0, 0.5]), gt2))
    cases.append((np.zeros((10, 3)), np.ones((10, 3))))
    rng = np.random.default_rng(7)
    for k, r in enumerate(rotations()[::3]):
        g = rng.standard_normal((15 + k, 3))
        e = (g @ r.T) * rng.uniform(0.2, 3.0) + rng.standard_normal(3)
        cases.append((e + 1e-3 * rng.standard_normal(e.shape), g))
    return cases


@pytest.mark.parametrize("i", range(len(_sim3_cases())))
def test_ate_matches_jax(i):
    est, gt = _sim3_cases()[i]
    for with_scale in (True, False):
        for a, b in zip(tate.umeyama_alignment(est, gt, with_scale),
                        jate.umeyama_alignment(est, gt, with_scale)):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    for align in ("sim3", "se3", "none"):
        np.testing.assert_allclose(tate.ate_rmse(est, gt, align), jate.ate_rmse(est, gt, align),
                                   rtol=RTOL, atol=ATOL)


def test_depth_rmse_and_associate_match_jax():
    rng = np.random.default_rng(1)
    gt = rng.uniform(0.5, 2.0, (16, 20))
    for est, mask in ((gt * 2.0, np.ones_like(gt)), (gt + rng.normal(0, 0.1, gt.shape),
                                                     (rng.random(gt.shape) > 0.3).astype(np.float32)),
                      (gt, np.zeros_like(gt))):
        for align in (True, False):
            np.testing.assert_allclose(tate.depth_rmse(est, gt, mask, align),
                                       jate.depth_rmse(est, gt, mask, align), rtol=RTOL, atol=ATOL)
    est = [(1.0, np.zeros(3)), (2.0, np.ones(3)), (3.01, np.full(3, 2.0))]
    gt = [(1.005, np.zeros(3)), (2.5, np.ones(3)), (3.0, np.full(3, 5.0))]
    for max_dt in (0.02, 0.5, 1e-4):
        for a, b in zip(tate.associate(est, gt, max_dt), jate.associate(est, gt, max_dt)):
            np.testing.assert_array_equal(a, b)


def test_ate_rejects_mismatched_shapes():
    with pytest.raises(ValueError):
        tate.ate_rmse(np.zeros((4, 3)), np.zeros((5, 3)))


def test_load_net_configs_matches_jax(tmp_path):
    """eval_artifacts/net_netcfg.json and test_netcfg_sidecar_roundtrip's
    sidecar load to the same configs in both packages, with tuples for
    lists (the configs stay hashable)."""
    from sage_slam_tpu.models.depth_network import DepthNetConfig as JD
    from sage_slam_tpu.models.feature_network import FeatureNetConfig as JF

    side = tmp_path / "netcfg.json"
    dcfg = JD(filter_list=(4, 8), bottleneck=8, bias_inner=(8, 1), basis_inner=((8, 4),))
    fcfg = JF(filter_list=(4, 8), bottleneck=8, desc_inner=(8, 8), map_inner=(8, 8))
    side.write_text(json.dumps({"depth": dcfg._asdict(), "feat": fcfg._asdict()}))
    only_depth = tmp_path / "depth_only.json"
    only_depth.write_text(json.dumps({"depth": dcfg._asdict()}))
    for path in (os.path.join(ROOT, "eval_artifacts", "net_netcfg.json"), str(side), str(only_depth)):
        t_cfgs, j_cfgs = texport.load_net_configs(path), jexport.load_net_configs(path)
        for t, j in zip(t_cfgs, j_cfgs):
            if j is None:
                assert t is None
                continue
            assert type(t).__name__ == type(j).__name__
            assert tuple(t) == tuple(j)
            hash(t)
    from sage_slam_tpu_torch.models.depth_network import DepthNetConfig as TD
    from sage_slam_tpu_torch.models.feature_network import FeatureNetConfig as TF

    assert texport.load_net_configs(str(side)) == (TD(**dcfg._asdict()), TF(**fcfg._asdict()))


def test_write_tum_reads_the_card_once(tmp_path, monkeypatch):
    """write_tum moves a trajectory to the host in one read per array (two
    stacks), not one per pose."""
    poses = [(float(i), SE3(torch.eye(3), torch.full((3,), float(i)))) for i in range(5)]
    reads = []
    cpu = torch.Tensor.cpu

    def counting_cpu(self, *a, **k):
        reads.append(tuple(self.shape))
        return cpu(self, *a, **k)

    monkeypatch.setattr(torch.Tensor, "cpu", counting_cpu)
    ttum.write_tum(str(tmp_path / "t.txt"), poses)
    assert reads == [(5, 3, 3), (5, 3)]
