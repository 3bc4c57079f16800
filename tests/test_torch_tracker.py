"""Port parity of the tracker slice: the tracker's photometric, reprojection
and match-geometry terms, feature_matching_geo, lm_track (6 and 7 DoF),
area_inlier_motion and convex_hull_area, against the JAX functions on the
same numpy inputs (CPU)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sage_slam_tpu.config import TrackerConfig as JTrackerConfig
from sage_slam_tpu.geometry.camera import CameraPyramid as JPyr
from sage_slam_tpu.geometry.camera import PinholeCamera as JCam
from sage_slam_tpu.geometry.interp import locations_1d_to_homo
from sage_slam_tpu.geometry.se3 import se3_exp
from sage_slam_tpu.ops import match_geometry as jmg
from sage_slam_tpu.ops import reprojection as jrp
from sage_slam_tpu.ops.pyramid import gaussian_pyramid_with_grad, mask_pyramid
from sage_slam_tpu.tracker import matcher as jmatcher
from sage_slam_tpu.tracker import matching_geo as jmatching_geo
from sage_slam_tpu.tracker import tracker as jtracker
from sage_slam_tpu_torch.config import TrackerConfig
from sage_slam_tpu_torch.geometry.camera import CameraPyramid, PinholeCamera
from sage_slam_tpu_torch.ops import match_geometry as tmg
from sage_slam_tpu_torch.ops import reprojection as trp
from sage_slam_tpu_torch.tracker import matching_geo as tmatching_geo
from sage_slam_tpu_torch.tracker import tracker as ttracker
from tests.test_tracker import build_scene

torch.set_num_threads(1)

H, W, FS, LEVELS, N = 48, 64, 4, 3, 400
EPS = 1e-6


def _t(x):
    return torch.from_numpy(np.array(x))


def _cams():
    args = dict(fx=W * 1.2, fy=W * 1.2, cx=W / 2 - 0.5, cy=H / 2 - 0.5, width=W, height=H)
    return JCam(**args), PinholeCamera(**args)


class Scene:
    """tests/test_tracker.py's scene (smooth features, samples at depth
    1.5, the frame's features identical, so the optimum is the identity)
    seen through a circular mask, so that the gate matters; both packages'
    TrackerRef / TrackerTarget from the same numpy arrays."""

    def __init__(self, seed=0):
        rng = np.random.default_rng(seed)
        jcam, tcam = _cams()
        self.jpyr, self.tpyr = JPyr.build(jcam, LEVELS), CameraPyramid.build(tcam, LEVELS)
        self.jcam, self.tcam = jcam, tcam

        yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
        feat = np.stack([np.sin(0.18 * xx + 0.9 * c) * np.cos(0.13 * yy + 0.5 * c)
                         for c in range(FS)]).astype(np.float32)
        self.mask = (((xx - (W - 1) / 2) ** 2 + (yy - (H - 1) / 2) ** 2) <= (0.45 * W) ** 2
                     ).astype(np.float32)
        fpyr, gpyr = gaussian_pyramid_with_grad(jnp.asarray(feat), mask_pyramid(jnp.asarray(self.mask), LEVELS),
                                                LEVELS)
        valid = np.flatnonzero(self.mask.reshape(-1) > 0.5)
        loc1d = rng.choice(valid, N, replace=False).astype(np.int32)
        homo = locations_1d_to_homo(jnp.asarray(loc1d), jcam)
        dpts = np.full(N, 1.5, np.float32)
        feats0 = jtracker._sample_source_features(fpyr, jnp.asarray(loc1d), self.jpyr)
        self.jref = jtracker.TrackerRef(photo_homo0=homo, photo_dpts0=jnp.asarray(dpts),
                                        cat_photo_feats0=feats0)
        self.jtarget = jtracker.TrackerTarget(feat_pyr=fpyr, grad_pyr=gpyr,
                                              mask_flat=jnp.asarray(self.mask.reshape(-1)))
        self.tref = ttracker.TrackerRef(_t(homo), _t(dpts), _t(feats0))
        self.ttarget = ttracker.TrackerTarget(_t(fpyr), _t(gpyr), _t(self.mask.reshape(-1)))


@pytest.fixture(scope="module")
def scene():
    return Scene()


def _pose(tau):
    p = se3_exp(jnp.asarray(tau, jnp.float32))
    return p.rot, p.trans, _t(p.rot), _t(p.trans)


TAU = [0.02, -0.015, 0.01, 0.01, -0.02, 0.015]


@pytest.mark.parametrize("with_scale", [False, True], ids=["6dof", "7dof"])
@pytest.mark.parametrize("soft", [False, True], ids=["binary", "soft"])
def test_tracker_photo_terms_match_jax(scene, with_scale, soft):
    """tracker_photo_jac_error and tracker_photo_error at a perturbed pose
    (points leave the mask, so the gate is not all ones). Tolerance:
    AtA/Atb rtol 1e-4 + atol 1e-6 max|AtA| (float32 sums in another
    order), error rtol 1e-5, n_inl exact for the binary gate and rtol 1e-5
    for the soft one."""
    jr, jt, tr, tt = _pose([0.08, -0.05, 0.03, 0.02, -0.04, 0.03])
    w = (10.0, 9.0, 8.0, 7.0)
    s_j = jnp.asarray(1.3) if with_scale else None
    s_t = torch.tensor(1.3) if with_scale else None
    j = jtracker.tracker_photo_jac_error(jr, jt, scene.jref, scene.jtarget, scene.jpyr, w, EPS,
                                         scale0=s_j, soft=soft)
    t = ttracker.tracker_photo_jac_error(tr, tt, scene.tref, scene.ttarget, scene.tpyr, w, EPS,
                                         scale0=s_t, soft=soft)
    dim = 7 if with_scale else 6
    assert t[0].shape == (dim, dim) and t[1].shape == (dim,)
    scale = float(np.abs(np.asarray(j[0])).max())
    np.testing.assert_allclose(t[0].numpy(), np.asarray(j[0]), rtol=1e-4, atol=1e-6 * scale)
    np.testing.assert_allclose(t[1].numpy(), np.asarray(j[1]), rtol=1e-4, atol=1e-6 * scale)
    np.testing.assert_allclose(float(t[2]), float(j[2]), rtol=1e-5)
    if soft:
        np.testing.assert_allclose(float(t[3]), float(j[3]), rtol=1e-5)
    else:
        assert float(t[3]) == float(j[3])
    assert 0 < float(t[3]) < N
    e_j = jtracker.tracker_photo_error(jr, jt, scene.jref, scene.jtarget, scene.jpyr, w, EPS, soft=soft)
    e_t = ttracker.tracker_photo_error(tr, tt, scene.tref, scene.ttarget, scene.tpyr, w, EPS, soft=soft)
    np.testing.assert_allclose(float(e_t[0]), float(e_j[0]), rtol=1e-5)
    np.testing.assert_allclose(float(e_t[1]), float(e_j[1]), rtol=1e-5)


def test_tracker_target_tables(scene):
    """with_packed builds the JAX tables (gathers of the same pyramids:
    equal), once; a target with them gives JAX's error."""
    jt = scene.jtarget.with_packed(scene.jpyr)
    tt = scene.ttarget.with_packed(scene.tpyr)
    np.testing.assert_array_equal(tt.tables.packed_fg.numpy(), np.asarray(jt.packed_fg))
    np.testing.assert_array_equal(tt.tables.packed_feat.numpy(), np.asarray(jt.packed_feat))
    assert len(tt.tables.dense_fg) == len(jt.dense_fg) == 1
    np.testing.assert_array_equal(tt.tables.dense_fg[0].numpy(), np.asarray(jt.dense_fg[0]))
    assert tt.with_packed(scene.tpyr) is tt
    assert tt.tables.bias_at is None and tt.tables.jac_at is None  # no sampled pixels
    jr, jtr, tr, ttr = _pose([0.08, -0.05, 0.03, 0.02, -0.04, 0.03])
    w = (10.0, 9.0, 8.0, 7.0)
    e_t = ttracker.tracker_photo_error(tr, ttr, scene.tref, tt, scene.tpyr, w, EPS)
    e_j = jtracker.tracker_photo_error(jr, jtr, scene.jref, jt, scene.jpyr, w, EPS)
    np.testing.assert_allclose(float(e_t[0]), float(e_j[0]), rtol=1e-5)
    np.testing.assert_allclose(float(e_t[1]), float(e_j[1]), rtol=1e-5)


def _matches(seed=0, m=40):
    """Match sets for the match-based terms: rays, depths, matched pixels
    and frame-1 points near the truth, some matches invalid."""
    rng = np.random.default_rng(seed)
    jcam, _ = _cams()
    loc = rng.choice(H * W, m, replace=False)
    homo0 = np.asarray(locations_1d_to_homo(jnp.asarray(loc), jcam))
    d0 = rng.uniform(1.0, 2.0, m).astype(np.float32)
    x1 = d0[:, None] * homo0 + np.array([0.01, -0.02, 0.03], np.float32)
    uv = np.stack([x1[:, 0] / x1[:, 2] * jcam.fx + jcam.cx, x1[:, 1] / x1[:, 2] * jcam.fy + jcam.cy], -1)
    d1 = (x1[:, 2] + rng.normal(0, 0.01, m)).astype(np.float32)
    homo1 = (x1 / x1[:, 2:3] + np.concatenate([rng.normal(0, 0.002, (m, 2)), np.zeros((m, 1))], -1))
    valid = (rng.uniform(size=m) > 0.2).astype(np.float32)
    return dict(homo0=homo0.astype(np.float32), d0=d0, d1=d1, homo1=homo1.astype(np.float32),
                matched=(uv + rng.normal(0, 0.7, (m, 2))).astype(np.float32), valid=valid)


@pytest.mark.parametrize("with_scale", [False, True], ids=["6dof", "7dof"])
def test_tracker_match_terms_match_jax(with_scale):
    """tracker_reproj_jac_error and tracker_mg_jac_error at a perturbed
    pose; an all-invalid set takes the zero-inlier penalty. Tolerance:
    AtA/Atb rtol 1e-4 + atol 1e-6 max|AtA|, error rtol 1e-5."""
    d = _matches()
    jcam, tcam = _cams()
    jr, jt, tr, tt = _pose([0.005, 0.01, -0.01, 0.01, 0.005, -0.01])
    s_j, s_t = (jnp.asarray(1.2), torch.tensor(1.2)) if with_scale else (None, None)
    lp = 0.03 * W**2

    def close(t, j, scale):
        np.testing.assert_allclose(t[0].numpy(), np.asarray(j[0]), rtol=1e-4, atol=1e-6 * scale)
        np.testing.assert_allclose(t[1].numpy(), np.asarray(j[1]), rtol=1e-4, atol=1e-6 * scale)
        np.testing.assert_allclose(float(t[2]), float(j[2]), rtol=1e-5)

    for valid in (d["valid"], np.zeros_like(d["valid"])):
        j = jrp.tracker_reproj_jac_error(jr, jt, jnp.asarray(d["d0"]), jnp.asarray(d["homo0"]),
                                         jnp.asarray(d["matched"]), jnp.asarray(valid), jcam, 0.07,
                                         lp, EPS, scale0=s_j)
        t = trp.tracker_reproj_jac_error(tr, tt, _t(d["d0"]), _t(d["homo0"]), _t(d["matched"]),
                                         _t(valid), tcam, torch.tensor(0.07), lp, EPS, scale0=s_t)
        close(t, j, max(float(np.abs(np.asarray(j[0])).max()), 1e-30))
        assert float(t[3]) == float(j[3])
        j = jmg.tracker_mg_jac_error(jr, jt, jnp.asarray(d["d0"]), jnp.asarray(d["d1"]),
                                     jnp.asarray(d["homo0"]), jnp.asarray(d["homo1"]),
                                     jnp.asarray(valid), 0.1, 0.1, scale0=s_j)
        t = tmg.tracker_mg_jac_error(tr, tt, _t(d["d0"]), _t(d["d1"]), _t(d["homo0"]),
                                     _t(d["homo1"]), _t(valid), 0.1, 0.1, scale0=s_t)
        close(t, j, max(float(np.abs(np.asarray(j[0])).max()), 1e-30))
    assert float(t[2]) == pytest.approx(0.1 * 10.0) and float(t[0].abs().max()) == 0.0


def test_feature_matching_geo_matches_jax():
    """The JAX keypoints injected: the same matches, registration inliers
    and ratios (exact), the sim(3) guess within 1e-4."""
    rng = np.random.default_rng(2)
    h, w, c = 16, 20, 8
    jcam = JCam(18.0, 18.0, 9.5, 7.5, w, h)
    tcam = PinholeCamera(18.0, 18.0, 9.5, 7.5, w, h)
    desc0 = rng.standard_normal((h * w, c)).astype(np.float32)
    desc1 = np.roll(desc0.reshape(h, w, c), 1, axis=1).reshape(-1, c)
    desc1[::9] = rng.standard_normal((len(desc1[::9]), c))
    dpt0 = rng.uniform(1.0, 1.6, h * w).astype(np.float32)
    dpt1 = (np.roll(dpt0.reshape(h, w), 1, axis=1).reshape(-1) * 1.1).astype(np.float32)
    valid = np.arange(h * w, dtype=np.int32)
    key = jax.random.key(7)
    kps = np.asarray(jmatcher.select_keypoints(key, jnp.asarray(valid), 32))
    j = jmatching_geo.feature_matching_geo(key, jnp.asarray(desc0), jnp.asarray(desc1), jnp.asarray(valid),
                                           jnp.asarray(dpt0), jnp.asarray(dpt1), jcam, 32, 2.0, 2.0,
                                           estimate_scale=True, dpt_scale_1=jnp.asarray(1.1))
    t = tmatching_geo.feature_matching_geo(7, _t(desc0), _t(desc1), _t(valid).long(), _t(dpt0), _t(dpt1),
                                           tcam, 32, 2.0, 2.0, estimate_scale=True, dpt_scale_1=1.1,
                                           keypoints=_t(kps).long())
    np.testing.assert_array_equal(t.matches.loc1d_1.numpy(), np.asarray(j.matches.loc1d_1))
    np.testing.assert_array_equal(t.inliers.numpy(), np.asarray(j.inliers))
    np.testing.assert_array_equal(t.matched_2d_1.numpy(), np.asarray(j.matched_2d_1))
    np.testing.assert_array_equal(t.dpts0.numpy(), np.asarray(j.dpts0))
    assert float(t.relative_desc_inlier_ratio) == float(j.relative_desc_inlier_ratio)
    assert float(t.desc_inlier_ratio) == float(j.desc_inlier_ratio)
    assert 0.5 < float(t.relative_desc_inlier_ratio) <= 1.0
    np.testing.assert_allclose(t.guess_rot.numpy(), np.asarray(j.guess_rot), atol=1e-4)
    np.testing.assert_allclose(t.guess_trans.numpy(), np.asarray(j.guess_trans), atol=1e-4)
    np.testing.assert_allclose(float(t.guess_scale), float(j.guess_scale), rtol=1e-4)
    # the default draw is seeded and inside the valid set
    drawn = tmatching_geo.feature_matching_geo(7, _t(desc0), _t(desc1), _t(valid).long(), _t(dpt0),
                                               _t(dpt1), tcam, 32, 2.0, 2.0)
    assert len(set(drawn.matches.loc1d_0.tolist())) == 32


class TrackScene:
    """tests/test_tracker.py's build_scene (all-ones mask, the optimum at
    the identity) in both packages, with match sets of its own samples
    under the identity plus a little noise: reprojection pixels and
    match-geometry points."""

    def __init__(self, seed=3, m=48):
        self.jref, self.jtarget, self.jpyr, jcam = build_scene()
        self.tref = ttracker.TrackerRef(*(_t(x) for x in self.jref))
        self.ttarget = ttracker.TrackerTarget(_t(self.jtarget.feat_pyr), _t(self.jtarget.grad_pyr),
                                              _t(self.jtarget.mask_flat))
        self.tpyr = CameraPyramid.build(
            PinholeCamera(jcam.fx, jcam.fy, jcam.cx, jcam.cy, jcam.width, jcam.height), self.jpyr.levels)
        rng = np.random.default_rng(seed)
        idx = rng.choice(self.jref.photo_dpts0.shape[0], m, replace=False)
        homo0 = np.asarray(self.jref.photo_homo0)[idx]
        d0 = np.asarray(self.jref.photo_dpts0)[idx]
        uv = np.stack([homo0[:, 0] * jcam.fx + jcam.cx, homo0[:, 1] * jcam.fy + jcam.cy], -1)
        self.matches = dict(
            d0=d0, homo0=homo0, matched=(uv + rng.normal(0, 0.3, (m, 2))).astype(np.float32),
            d1=(d0 + rng.normal(0, 0.005, m)).astype(np.float32), homo1=homo0,
            valid=(rng.uniform(size=m) > 0.1).astype(np.float32))
        self.width = jcam.width

    def terms(self, kind, valid=None):
        """(JAX TrackTerms, port TrackTerms) of one kind of match term."""
        d = dict(self.matches, valid=self.matches["valid"] if valid is None else valid)
        if kind == "reproj":
            kw = dict(reproj_weight=0.05, reproj_loss_param=0.03 * self.width**2)
            names = dict(reproj_dpts0="d0", reproj_homo0="homo0", reproj_matched_2d="matched",
                         reproj_valid="valid")
        else:
            kw = dict(mg_weight=0.1, mg_loss_param=0.1)
            names = dict(mg_dpts0="d0", mg_homo0="homo0", mg_dpts1="d1", mg_homo1="homo1", mg_valid="valid")
        return (jtracker.TrackTerms(**{k: jnp.asarray(d[v]) for k, v in names.items()}, **kw),
                ttracker.TrackTerms(**{k: _t(d[v]) for k, v in names.items()}, **kw))


@pytest.fixture(scope="module")
def track_scene():
    return TrackScene()


LM_CASES = {
    # TrackerConfig() defaults (coarse-to-fine, soft gate); 2 coarse + 2 fine
    "6dof_coarse_to_fine_reproj": dict(over={}, kind="reproj", with_scale=False, budget=4),
    "7dof_match_geometry": dict(over=dict(coarse_to_fine=False, soft_inlier_gate=False), kind="mg",
                                with_scale=True, budget=3),
}


@pytest.mark.parametrize("case", sorted(LM_CASES))
def test_lm_track_matches_jax(track_scene, case):
    """lm_track from tests/test_tracker.py's perturbed start. The budgets
    end each run while every step still lowers the error by far more than
    the float32 difference of the two packages' errors: near the optimum a
    step's accept test compares errors equal to float32 roundoff (a tie),
    and XLA's fused loop decides such ties its own way. Iterations equal;
    rot, trans and scale within 1e-5; the error rtol 1e-4."""
    c = LM_CASES[case]
    sc = track_scene
    jterms, tterms = sc.terms(c["kind"])
    jcfg = dataclasses.replace(JTrackerConfig(), **c["over"])
    tcfg = dataclasses.replace(TrackerConfig(), **c["over"])
    jr, jt, tr, tt = _pose(TAU)
    kw = dict(with_scale=c["with_scale"], init_scale=1.1, max_iters=c["budget"])
    rj = jax.jit(lambda r, t: jtracker.lm_track(r, t, sc.jref, sc.jtarget, sc.jpyr, jcfg, terms=jterms,
                                                **kw))(jr, jt)
    rt = ttracker.lm_track(tr, tt, sc.tref, sc.ttarget, sc.tpyr, tcfg, terms=tterms, **kw)
    assert rt.iterations == int(rj.iterations) == c["budget"]
    np.testing.assert_allclose(rt.rot.numpy(), np.asarray(rj.rot), atol=1e-5)
    np.testing.assert_allclose(rt.trans.numpy(), np.asarray(rj.trans), atol=1e-5)
    np.testing.assert_allclose(float(rt.scale), float(rj.scale), atol=1e-5)
    np.testing.assert_allclose(float(rt.error), float(rj.error), rtol=1e-4)
    # the perturbation (0.02 in translation) is mostly undone
    assert float(rt.trans.abs().max()) < 2e-3


def test_lm_track_at_the_optimum_converges_at_once(track_scene):
    """From the identity with the photometric term only every residual is
    float32 roundoff: max|Atb| far below min_grad_thresh ends each phase in
    its first iteration without a step, in both packages."""
    sc = track_scene
    eye, zero = torch.eye(3), torch.zeros(3)
    rj = jtracker.lm_track(jnp.eye(3), jnp.zeros(3), sc.jref, sc.jtarget, sc.jpyr, JTrackerConfig(),
                           max_iters=10)
    rt = ttracker.lm_track(eye, zero, sc.tref, sc.ttarget, sc.tpyr, TrackerConfig(), max_iters=10)
    assert rt.iterations == int(rj.iterations) == 2  # one per coarse-to-fine phase
    assert torch.equal(rt.rot, eye) and torch.equal(rt.trans, zero)
    assert float(rt.error) < 1e-10 and float(rj.error) < 1e-10


def test_lm_track_singular_system_takes_no_step(track_scene):
    """With no photometric term and no valid match the 6x6 system is zero:
    the solve's step is zeroed (torch.linalg.solve_ex info != 0), nothing
    is accepted, and the pose comes back unchanged as in JAX."""
    sc = track_scene
    jterms, tterms = sc.terms("reproj", valid=np.zeros_like(sc.matches["valid"]))
    jr, jt, tr, tt = _pose(TAU)
    rt = ttracker.lm_track(tr, tt, sc.tref, sc.ttarget, sc.tpyr, TrackerConfig(), terms=tterms,
                           use_photo=False, max_iters=5)
    rj = jtracker.lm_track(jr, jt, sc.jref, sc.jtarget, sc.jpyr, JTrackerConfig(), terms=jterms,
                           use_photo=False, max_iters=5)
    assert rt.iterations == int(rj.iterations) == 1
    assert torch.equal(rt.rot, tr) and torch.equal(rt.trans, tt)
    assert float(rt.error) == float(rj.error) == pytest.approx(0.5)


def test_area_inlier_motion_and_hull_match_jax(scene):
    """The metrics at a perturbed pose through the circular mask: equal
    validity and inlier ratio, points and motion within float32 roundoff;
    the hull area of the same points equals JAX's."""
    rng = np.random.default_rng(3)
    v = 300
    valid = np.flatnonzero(scene.mask.reshape(-1) > 0.5)
    loc1d = rng.choice(valid, v, replace=False).astype(np.int32)
    homo = np.asarray(locations_1d_to_homo(jnp.asarray(loc1d), scene.jcam))
    dpts = rng.uniform(1.2, 1.8, v).astype(np.float32)
    jr, jt, tr, tt = _pose([0.06, 0.04, -0.02, 0.03, 0.05, -0.02])
    j = jtracker.area_inlier_motion(jnp.asarray(dpts), jnp.asarray(homo), jr, jt, scene.jcam,
                                    jnp.asarray(scene.mask.reshape(-1)), EPS)
    t = ttracker.area_inlier_motion(_t(dpts), _t(homo), tr, tt, scene.tcam,
                                    _t(scene.mask.reshape(-1)), EPS)
    np.testing.assert_array_equal(t["within"].numpy(), np.asarray(j["within"]))
    np.testing.assert_array_equal(t["pos"].numpy(), np.asarray(j["pos"]))
    assert float(t["inlier_ratio"]) == float(j["inlier_ratio"])
    assert 0.5 < float(t["inlier_ratio"]) < 1.0
    for key in ("warped_2d", "source_2d"):
        np.testing.assert_allclose(t[key].numpy(), np.asarray(j[key]), rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(float(t["average_motion"]), float(j["average_motion"]), rtol=1e-5)
    inside = np.asarray(j["within"]) > 0.5
    warped = np.asarray(j["warped_2d"])[inside]
    assert ttracker.convex_hull_area(warped) == jtracker.convex_hull_area(warped)
    assert ttracker.convex_hull_area(t["source_2d"].numpy()) == pytest.approx(
        jtracker.convex_hull_area(np.asarray(j["source_2d"])), rel=1e-6)


def test_convex_hull_area_cases():
    """A unit square with an inside point, collinear and fewer than three
    points, and random clouds: the port's copy equals the JAX package's."""
    sq = np.array([[0, 0], [1, 0], [1, 1], [0, 1], [0.5, 0.5]])
    assert ttracker.convex_hull_area(sq) == pytest.approx(1.0, abs=1e-12)
    assert ttracker.convex_hull_area(np.array([[0, 0], [1, 1]])) == 0.0
    assert ttracker.convex_hull_area(np.array([[0, 0], [1, 1], [2, 2]])) == 0.0
    rng = np.random.default_rng(0)
    for _ in range(5):
        pts = rng.uniform(-40, 40, (200, 2)).astype(np.float32)
        assert ttracker.convex_hull_area(pts) == jtracker.convex_hull_area(pts)


def test_torch_round_is_half_to_even():
    """area_inlier_motion's nearest-pixel rounding: torch.round and
    jnp.round agree on exact halves."""
    x = np.array([-1.5, -0.5, 0.5, 1.5, 2.5, 3.5, 62.5], np.float32)
    np.testing.assert_array_equal(torch.round(_t(x)).numpy(), np.asarray(jnp.round(jnp.asarray(x))))
