"""Port parity of the reprojection path: matcher, GNC-TLS registration, the
residual geometry, depth decode and fair loss, the reprojection factor, its
BA terms and the Mapper's reprojection edges, against the JAX functions on
the same matches (CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sage_slam_tpu.config import MapperConfig as JaxMapperConfig
from sage_slam_tpu.geometry.se3 import se3_exp
from sage_slam_tpu.ops import depth as jdepth
from sage_slam_tpu.ops import reprojection as jrp
from sage_slam_tpu.ops import residuals as jres
from sage_slam_tpu.ops import robust_loss as jloss
from sage_slam_tpu.solver import ba as jba
from sage_slam_tpu.tracker import matcher as jmatcher
from sage_slam_tpu.tracker import robust as jrobust
from sage_slam_tpu_torch import convert
from sage_slam_tpu_torch.config import MapperConfig
from sage_slam_tpu_torch.geometry.camera import PinholeCamera
from sage_slam_tpu_torch.geometry.se3 import SE3
from sage_slam_tpu_torch.ops import depth as tdepth
from sage_slam_tpu_torch.ops import reprojection as trp
from sage_slam_tpu_torch.ops import residuals as tres
from sage_slam_tpu_torch.ops import robust_loss as tloss
from sage_slam_tpu_torch.solver import ba as tba
from sage_slam_tpu_torch.tracker import matcher as tmatcher
from sage_slam_tpu_torch.tracker import robust as trobust
from tests.test_ba import add_reproj_edges, build_problem, perturbed_vars
from tests.test_match_reproj import scene
from tests.test_torch_mapper import Pair

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.array(x))


def _edges(e=3, seed=0):
    """E match sets of test_match_reproj.scene stacked on a leading edge axis."""
    scenes = [scene(seed=seed + i) for i in range(e)]
    stack = lambda key: np.stack([np.asarray(s[key]) for s in scenes])  # noqa: E731
    matched = []
    for s in scenes:
        loc = s["loc1"]
        jitter = np.random.default_rng(9).normal(0, 0.7, (len(loc), 2))
        matched.append(np.stack([loc % 20, loc // 20], -1) + jitter)
    return scenes, dict(
        rot0=np.stack([np.asarray(s["p0"].rot) for s in scenes]),
        trans0=np.stack([np.asarray(s["p0"].trans) for s in scenes]),
        rot1=np.stack([np.asarray(s["p1"].rot) for s in scenes]),
        trans1=np.stack([np.asarray(s["p1"].trans) for s in scenes]),
        code0=stack("code0"), scale0=stack("scale0"), bias0=stack("bias0"), jac0=stack("jac0"),
        loc0=stack("loc0"), homo0=stack("homo0"), valid=stack("valid"),
        matched=np.stack(matched).astype(np.float32), weight=np.array([0.1, 0.05, 0.2], np.float32),
    )


def _jax_args(d):
    from sage_slam_tpu.geometry.se3 import SE3 as JSE3

    return (
        JSE3(jnp.asarray(d["rot0"]), jnp.asarray(d["trans0"])),
        JSE3(jnp.asarray(d["rot1"]), jnp.asarray(d["trans1"])),
        jnp.asarray(d["code0"]), jnp.asarray(d["scale0"]), jnp.asarray(d["bias0"]),
        jnp.asarray(d["jac0"]),
        jrp.ReprojMatchSet(jnp.asarray(d["loc0"]), jnp.asarray(d["homo0"]),
                           jnp.asarray(d["matched"]), jnp.asarray(d["valid"])),
    )


def _port_args(d):
    return (
        SE3(_t(d["rot0"]), _t(d["trans0"])), SE3(_t(d["rot1"]), _t(d["trans1"])),
        _t(d["code0"]), _t(d["scale0"]), _t(d["bias0"]), _t(d["jac0"]),
        trp.ReprojMatchSet(_t(d["loc0"]).long(), _t(d["homo0"]), _t(d["matched"]), _t(d["valid"])),
    )


def test_residual_geometry_depth_and_loss_match_jax():
    """warp, safe_points, projection, the three Jacobians, world points,
    depth decode and the fair loss, batched over 3 edges in the port and
    vmapped in JAX. Tolerance: float32 roundoff (rtol 1e-5, atol 1e-6)."""
    _, d = _edges()
    jp0, jp1, jcode, jscale, jbias, jjac, jm = _jax_args(d)
    tp0, tp1, tcode, tscale, tbias, tjac, tm = _port_args(d)
    close = lambda t, j: np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-6)  # noqa: E731

    d_j = jax.vmap(jdepth.decode_depth_at)(jbias, jjac, jm.loc1d_0, jcode, jscale)
    d_t = tdepth.decode_depth_at(tbias, tjac, tm.loc1d_0, tcode, tscale)
    close(d_t, d_j)
    close(tdepth.decode_depth(tbias, tjac, tcode, tscale),
          jax.vmap(jdepth.decode_depth)(jbias, jjac, jcode, jscale))
    close(tdepth.decode_depth(tbias[0], tjac[0], tcode[0], 1.3),
          jdepth.decode_depth(jbias[0], jjac[0], jcode[0], 1.3))

    rot10_j, t10_j = jax.vmap(jres.relative_pose_tensors)(jp0, jp1)
    rot10_t, t10_t = tres.relative_pose_tensors(tp0, tp1)
    close(rot10_t, rot10_j)
    w_j = jax.vmap(lambda h, dd, r, t: jres.warp(h, dd, r, t, 1e-6))(jm.homo_0, d_j, rot10_j, t10_j)
    w_t = tres.warp(tm.homo_0, d_t, rot10_t, t10_t, 1e-6)
    close(w_t.points_in_1, w_j.points_in_1)
    np.testing.assert_array_equal(w_t.pos_depth.numpy(), np.asarray(w_j.pos_depth))
    pts_t = tres.safe_points(w_t.points_in_1, w_t.pos_depth)
    pts_j = jax.vmap(jres.safe_points)(w_j.points_in_1, w_j.pos_depth)
    close(pts_t, pts_j)
    gated = tres.safe_points(w_t.points_in_1, torch.zeros_like(w_t.pos_depth))
    assert bool((gated[..., 2] == 1).all())
    uv_t = tres.project_full_res(pts_t, 18.0, 14.4, 9.5, 7.5)
    uv_j = jres.project_full_res(pts_j, 18.0, 14.4, 9.5, 7.5)
    close(uv_t[0], uv_j[0])
    close(tres.proj_jac_point(pts_t, 18.0, 14.4), jres.proj_jac_point(pts_j, 18.0, 14.4))
    xw_t = tres.points_world(tm.homo_0, d_t, tp0)
    xw_j = jax.vmap(jres.points_world)(jm.homo_0, d_j, jp0)
    close(xw_t, xw_j)
    close(tres.point_jac_pose0(xw_t, tp1.rot), jax.vmap(jres.point_jac_pose0)(xw_j, jp1.rot))
    close(tres.proj_jac_depth(w_t.rotated_homo, pts_t, 18.0, 14.4),
          jres.proj_jac_depth(w_j.rotated_homo, pts_j, 18.0, 14.4))

    diff = np.random.default_rng(0).normal(0, 2, (5, 2)).astype(np.float32)
    close(tloss.fair_error(_t(diff), 0.05), jloss.fair_error(jnp.asarray(diff), 0.05))
    close(tloss.fair_sqrt_weight(_t(diff), 0.05), jloss.fair_sqrt_weight(jnp.asarray(diff), 0.05))


def test_reprojection_factor_matches_jax():
    """jac_error and error batched over E=3 edges against the vmapped JAX
    factor; one edge with no valid match takes the zero-inlier penalty.
    Tolerance: ata/atb rtol 1e-4 + atol 1e-6 max|ata| (float32 sums in
    another order), error rtol 1e-5."""
    _, d = _edges()
    d["valid"][2] = 0.0
    cam = PinholeCamera(fx=18.0, fy=14.4, cx=9.5, cy=7.5, width=20, height=16)
    lp = 0.03 * 20.0**2
    j = jax.vmap(lambda p0, p1, c, s, b, jc, m, w: jrp.reprojection_jac_error(
        p0, p1, c, s, b, jc, m, cam, w, lp, 1e-6))(*_jax_args(d), jnp.asarray(d["weight"]))
    t = trp.reprojection_jac_error(*_port_args(d), cam, _t(d["weight"]), lp, 1e-6)
    scale = float(np.abs(np.asarray(j[0])).max())
    np.testing.assert_allclose(t[0].numpy(), np.asarray(j[0]), rtol=1e-4, atol=1e-6 * scale)
    np.testing.assert_allclose(t[1].numpy(), np.asarray(j[1]), rtol=1e-4, atol=1e-6 * scale)
    np.testing.assert_allclose(t[2].numpy(), np.asarray(j[2]), rtol=1e-5)
    np.testing.assert_array_equal(t[3].numpy(), np.asarray(j[3]))
    assert float(t[2][2]) == pytest.approx(0.2 * 10.0) and float(t[0][2].abs().max()) == 0.0
    je = jax.vmap(lambda p0, p1, c, s, b, jc, m, w: jrp.reprojection_error(
        p0, p1, c, s, b, jc, m, cam, w, lp, 1e-6))(*_jax_args(d), jnp.asarray(d["weight"]))
    te = trp.reprojection_error(*_port_args(d), cam, _t(d["weight"]), lp, 1e-6)
    np.testing.assert_allclose(te[0].numpy(), np.asarray(je[0]), rtol=1e-5)
    np.testing.assert_allclose(te[0].numpy(), t[2].numpy(), rtol=1e-5)


def test_ba_with_reprojection_edges_matches_jax():
    """tests/test_ba.py's problem with reprojection edges: linearize,
    total_error and a 6-iteration run_ba against JAX (the terms that lift
    the port's former NotImplementedError)."""
    p, pyr = build_problem()
    p = add_reproj_edges(p, pyr)
    v = perturbed_vars(3, 4)
    cfg = JaxMapperConfig()
    tv = convert.variables_from_numpy(jax.tree.map(np.asarray, v), device="cpu")
    tp = convert.problem_from_numpy(jax.tree.map(np.asarray, p), device="cpu")
    tpyr = convert.camera_pyramid_from_numpy(pyr)
    pj = jba.prepare_problem(p, pyr)
    h_j, b_j, e_j = jax.jit(lambda x: jba.linearize(x, pj, pyr, cfg))(v)
    tot_j = jax.jit(lambda x: jba.total_error(x, pj, pyr, cfg))(v)
    tpp = tba.prepare_problem(tp, tpyr)
    h_t, b_t, e_t = tba.linearize(tv, tpp, tpyr, MapperConfig())
    scale = float(jnp.max(jnp.abs(h_j)))
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), rtol=1e-4, atol=1e-5 * scale)
    np.testing.assert_allclose(b_t.numpy(), np.asarray(b_j), rtol=1e-4, atol=1e-5 * scale)
    np.testing.assert_allclose(float(e_t), float(e_j), rtol=1e-5)
    np.testing.assert_allclose(float(tba.total_error(tv, tpp, tpyr, MapperConfig())),
                               float(tot_j), rtol=1e-5)
    # the reprojection term is in there: without it the error is lower
    no_rp = tpp._replace(reproj_edges=None)
    assert float(tba.total_error(tv, no_rp, tpyr, MapperConfig())) < float(e_t)
    v_j, e_jr, it_j, conv_j = jax.jit(
        lambda x: jba.run_ba(x, p, pyr, cfg, jnp.ones(3), max_iters=6))(v)
    v_t, e_tr, it_t, conv_t = tba.run_ba(tv, tp, tpyr, MapperConfig(), torch.ones(3), max_iters=6)
    assert (it_t, conv_t) == (int(it_j), bool(conv_j))
    np.testing.assert_allclose(v_t.pose.trans.numpy(), np.asarray(v_j.pose.trans), atol=2e-6)
    np.testing.assert_allclose(v_t.code.numpy(), np.asarray(v_j.code), atol=1e-6)


def test_matcher_matches_jax():
    """Cycle-consistent matches on the same keypoints and descriptors equal
    JAX's; the port's keypoint draw is seeded, distinct and in the valid
    set (the JAX permutation cannot be reproduced)."""
    rng = np.random.default_rng(0)
    h, w, c = 16, 20, 8
    desc0 = rng.standard_normal((h * w, c)).astype(np.float32)
    desc1 = np.roll(desc0.reshape(h, w, c), 3, axis=1).reshape(-1, c)
    desc1[::7] = rng.standard_normal((len(desc1[::7]), c))  # break some cycles
    valid = np.arange(0, h * w, 2, dtype=np.int64)
    kps = np.asarray(jmatcher.select_keypoints(jax.random.key(4), jnp.asarray(valid), 40))
    m_j = jmatcher.cycle_consistent_matches(jnp.asarray(kps), jnp.asarray(desc0),
                                            jnp.asarray(desc1), w, 1.0)
    m_t = tmatcher.cycle_consistent_matches(_t(kps), _t(desc0), _t(desc1), w, 1.0)
    np.testing.assert_array_equal(m_t.loc1d_1.numpy(), np.asarray(m_j.loc1d_1))
    np.testing.assert_array_equal(m_t.valid.numpy(), np.asarray(m_j.valid))
    assert 0 < float(m_t.valid.sum()) < 40
    from sage_slam_tpu.geometry.camera import PinholeCamera as JCam

    cam = PinholeCamera(18.0, 14.4, 9.5, 7.5, w, h)
    h0_t, h1_t = tmatcher.matches_to_points(m_t, cam)
    h0_j, h1_j = jmatcher.matches_to_points(m_j, JCam(18.0, 14.4, 9.5, 7.5, w, h))
    np.testing.assert_allclose(h1_t.numpy(), np.asarray(h1_j), rtol=1e-6)
    k1 = tmatcher.select_keypoints(42, _t(valid), 10)
    k2 = tmatcher.select_keypoints(42, _t(valid), 10)
    assert torch.equal(k1, k2) and len(set(k1.tolist())) == 10
    assert set(k1.tolist()) <= set(valid.tolist())


def test_gnc_tls_registration_matches_jax():
    """Weighted Horn and 20 GNC-TLS iterations with 20% outliers: the same
    rotation, translation and inlier set as JAX; Umeyama scale too."""
    rng = np.random.default_rng(1)
    m = 60
    src = rng.uniform(-1, 1, (m, 3)).astype(np.float32)
    pose = se3_exp(jnp.asarray([0.1, -0.05, 0.2, 0.1, -0.2, 0.15], jnp.float32))
    dst = src @ np.asarray(pose.rot).T * 1.2 + np.asarray(pose.trans)
    out_idx = rng.choice(m, 12, replace=False)
    dst[out_idx] += rng.uniform(0.5, 2.0, (12, 3)).astype(np.float32)
    dst = dst.astype(np.float32)
    w = rng.uniform(0.2, 1.0, m).astype(np.float32)
    for est in (False, True):
        hj = jrobust._weighted_horn(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w), est)
        ht = trobust._weighted_horn(_t(src), _t(dst), _t(w), est)
        for a, b in zip(ht, hj):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5)
    bounds = np.full(m, 0.01, np.float32)
    valid = np.ones(m, np.float32)
    valid[:3] = 0.0
    rj = jrobust.gnc_tls_registration(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(bounds),
                                      jnp.asarray(valid), estimate_scale=True)
    rt = trobust.gnc_tls_registration(_t(src), _t(dst), _t(bounds), _t(valid), estimate_scale=True)
    np.testing.assert_allclose(rt.rot.numpy(), np.asarray(rj.rot), atol=1e-5)
    np.testing.assert_allclose(rt.trans.numpy(), np.asarray(rj.trans), atol=1e-5)
    np.testing.assert_allclose(float(rt.scale), float(rj.scale), rtol=1e-5)
    np.testing.assert_array_equal(rt.inliers.numpy(), np.asarray(rj.inliers))
    assert rt.inliers.numpy()[out_idx].sum() == 0
    depth_b = rng.uniform(0.8, 1.5, m).astype(np.float32)
    fj = jrobust.translation_inlier_filter(jnp.asarray(src), jnp.asarray(src + 0.3), jnp.asarray(depth_b),
                                           20.0, jnp.asarray(valid))
    ft = trobust.translation_inlier_filter(_t(src), _t(src + 0.3), _t(depth_b), 20.0, _t(valid))
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))


@pytest.fixture(scope="module")
def reproj_pair():
    """Mappers with use_reprojection=True; the port gets JAX's keypoints
    (drawn from the same per-edge seed) injected."""
    pair = Pair(use_reprojection=True)
    orig = pair.tm._add_reproj_edge
    k = pair.tm.cfg.mapper.desc_num_keypoints

    def with_jax_keypoints(i0, i1, keypoints=None):
        key = jax.random.key((i0 * max(pair.tm.store.num_active, 1) + i1) & 0x7FFFFFFF)
        kps = jmatcher.select_keypoints(key, pair.jm.valid_loc1d, k)
        return orig(i0, i1, keypoints=np.asarray(kps))

    pair.tm._add_reproj_edge = with_jax_keypoints
    pair.init()
    steps = []
    for f in (1, 2, 3):
        pair.add_keyframe(f)
        pair.jm.mapping_step()
        pair.tm.mapping_step()
        steps.append(((pair.jm.last_step_iters, pair.jm.last_step_converged),
                      (pair.tm.last_step_iters, pair.tm.last_step_converged),
                      pair.tm.last_step_edges))
    return pair, steps


def test_mapper_reprojection_edges_match_jax(reproj_pair):
    """The match sets the port's mapper built (same keypoints, frames and
    descriptors) equal JAX's: matches, inliers, weights."""
    pair, _ = reproj_pair
    assert len(pair.tm.reproj_edges) == len(pair.jm.reproj_edges) == 12
    for et, ej in zip(pair.tm.reproj_edges, pair.jm.reproj_edges):
        assert (et["i0"], et["i1"]) == (ej["i0"], ej["i1"])
        np.testing.assert_array_equal(et["loc1d_0"].numpy(), np.asarray(ej["loc1d_0"]))
        np.testing.assert_array_equal(et["match_valid"].numpy(), np.asarray(ej["match_valid"]))
        np.testing.assert_allclose(et["matched_2d_1"].numpy(), np.asarray(ej["matched_2d_1"]))
        np.testing.assert_allclose(et["homo_0"].numpy(), np.asarray(ej["homo_0"]), rtol=1e-6)
        np.testing.assert_allclose(float(et["weight"]), float(ej["weight"]), rtol=1e-6)


def test_mapping_with_reprojection_follows_jax(reproj_pair):
    """Steps with photometric, geometric and reprojection edges: equal
    iterations and converged flags, variables within float32 roundoff."""
    pair, steps = reproj_pair
    for jax_step, port_step, _ in steps:
        assert port_step == jax_step
    assert [edges[2] for _, _, edges in steps] == [2, 6, 12]
    jv = jax.tree.map(np.asarray, pair.jm.store.variables)
    tv = pair.tm.store.variables
    n = pair.tm.store.num_active
    np.testing.assert_allclose(tv.pose.trans[:n].numpy(), jv.pose.trans[:n], atol=2e-6)
    np.testing.assert_allclose(tv.code[:n].numpy(), jv.code[:n], atol=1e-6)


def test_enqueue_link_with_match_geometry(reproj_pair):
    """A loop link with match_geom adds reprojection edges both ways, as
    the reference's EnqueueLink does; the next step linearizes them."""
    pair, _ = reproj_pair
    n_rp = len(pair.tm.reproj_edges)
    pair.tm.enqueue_link(0, 3, photo=True, match_geom=True, geo=False, global_loop=True)
    assert len(pair.tm.reproj_edges) == n_rp + 2
    assert pair.tm.store.link_exists(0, 3) and (0, 3) in pair.tm.store.global_loop_links
    assert pair.tm.store.connections(3, temporal_only=True) == [1, 2]
    err = pair.tm.mapping_step(full=True)
    assert np.isfinite(err) and pair.tm.last_step_edges[2] == n_rp + 2
