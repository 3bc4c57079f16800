"""Port parity of the default-off mega tables (levels 0+1 and the mask in
one gather row) and of interp.valid_locations, against the JAX package on
the same numpy inputs (CPU).

The gathers sweep tests/test_mega.py's coordinates (exact integers, half
pixels, points outside the image): the port's mega gathers are bit-equal
to its own per-level quad gathers and to JAX's. The photometric path runs
with USE_MEGA_TABLES monkeypatched on in both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sage_slam_tpu.ops.photometric as jph
import sage_slam_tpu_torch.ops.photometric as tph
from sage_slam_tpu.config import MapperConfig as JMapperConfig
from sage_slam_tpu.geometry import interp as jinterp
from sage_slam_tpu.solver import ba as jba
from sage_slam_tpu.tracker import tracker as jtracker
from sage_slam_tpu_torch import convert
from sage_slam_tpu_torch.config import MapperConfig, TrackerConfig
from sage_slam_tpu_torch.geometry import interp as tinterp
from sage_slam_tpu_torch.solver import ba as tba
from sage_slam_tpu_torch.tracker import tracker as ttracker
from tests.test_ba import build_problem, perturbed_vars
from tests.test_torch_tracker import EPS, TAU, Scene, _pose

torch.set_num_threads(1)


def _sweep(w0, h0, rng):
    """test_mega01_bit_exact's coordinates."""
    us = np.concatenate([
        np.linspace(-3.0, w0 + 2.0, 2001),
        np.floor(np.linspace(-2, w0 + 1, 97)) + 0.5,
        np.floor(np.linspace(-2, w0 + 1, 97)) * 1.0,
    ]).astype(np.float32)
    vs = np.concatenate([
        np.linspace(-3.0, h0 + 2.0, 2001),
        np.floor(np.linspace(-2, h0 + 1, 97)) + 0.5,
        np.floor(np.linspace(-2, h0 + 1, 97)) * 1.0,
    ]).astype(np.float32)
    rng.shuffle(vs)
    return us, vs[: len(us)]


@pytest.mark.parametrize("h0,w0,c0,c1", [(16, 20, 5, 4), (8, 10, 13, 12)])
def test_mega01_bit_exact_against_per_level_and_jax(h0, w0, c0, c1):
    rng = np.random.default_rng(0)
    k = 2
    h1, w1 = h0 // 2, w0 // 2
    rows_l0 = rng.standard_normal((k, h0 * w0, c0)).astype(np.float32)
    rows_l1 = rng.standard_normal((k, h1 * w1, c1)).astype(np.float32)
    mega_j = jinterp.build_mega01(jnp.asarray(rows_l0), jnp.asarray(rows_l1), w0, h0)
    mega_t = tinterp.build_mega01(torch.from_numpy(rows_l0), torch.from_numpy(rows_l1), w0, h0)
    r = (w0 + 1) * (h0 + 1)
    assert mega_t.shape == (4 * c0 + 9 * c1 + 2, k * r)
    np.testing.assert_array_equal(mega_t.numpy(), np.asarray(mega_j))
    with pytest.raises(ValueError):
        tinterp.build_mega01(torch.from_numpy(rows_l0), torch.from_numpy(rows_l1), w0, h0 + 2)

    q0 = tinterp.pack_quads_level(torch.from_numpy(rows_l0), w0)
    q1 = tinterp.pack_quads_level(torch.from_numpy(rows_l1), w1)
    us, vs = _sweep(w0, h0, rng)
    uj, vj = jnp.asarray(us), jnp.asarray(vs)
    ut, vt = torch.from_numpy(us), torch.from_numpy(vs)
    u1t, v1t = tinterp.level_coords(ut, vt, 0.5, 0.5)
    u1j, v1j = jinterp.level_coords(uj, vj, 0.5, 0.5)
    for kk in range(k):
        ref0 = tinterp.bilinear_quad(q0[kk], ut, vt, w0, h0)
        ref1 = tinterp.bilinear_quad(q1[kk], u1t, v1t, w1, h1)
        rowv, wts, xc, yc = tinterp.mega_gather(mega_t, ut, vt, w0, h0, offset=kk * r)
        got0 = tinterp.combine_quad_cm(rowv, wts, c0, c0)
        got1 = tinterp.mega_level1(rowv, u1t, v1t, w1, h1, c0, c1)
        # against the port's own per-level quad gathers: bit-equal
        np.testing.assert_array_equal(got0.T.numpy(), ref0.numpy())
        np.testing.assert_array_equal(got1.T.numpy(), ref1.numpy())
        # against JAX's mega functions
        rowv_j, wts_j, xc_j, yc_j = jinterp.mega_gather(mega_j, uj, vj, w0, h0, offset=kk * r)
        np.testing.assert_array_equal(rowv.numpy(), np.asarray(rowv_j))
        for a, b in zip(wts, wts_j):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(xc.numpy(), np.asarray(xc_j))
        np.testing.assert_array_equal(yc.numpy(), np.asarray(yc_j))
        got1_j = jinterp.mega_level1(rowv_j, u1j, v1j, w1, h1, c0, c1)
        np.testing.assert_array_equal(got1.numpy(), np.asarray(got1_j))
    # batched over a leading edge axis with per-edge frame offsets
    rowv_b, _, _, _ = tinterp.mega_gather(
        mega_t, torch.stack([ut, ut]), torch.stack([vt, vt]), w0, h0,
        offset=torch.tensor([0, r]),
    )
    np.testing.assert_array_equal(rowv_b[1].numpy(),
                                  tinterp.mega_gather(mega_t, ut, vt, w0, h0, r)[0].numpy())


def test_valid_locations_exact():
    rng = np.random.default_rng(3)
    h, w = 12, 17
    mask = (rng.random(h * w) > 0.4).astype(np.float32)
    fx, fy, cx, cy = 18.7, 19.1, 8.0, 5.5
    homo_j, valid_j = jinterp.valid_locations(jnp.asarray(mask), w, fx, fy, cx, cy)
    homo_t, valid_t = tinterp.valid_locations(torch.from_numpy(mask), w, fx, fy, cx, cy)
    np.testing.assert_array_equal(homo_t.numpy(), np.asarray(homo_j))
    np.testing.assert_array_equal(valid_t.numpy(), np.asarray(valid_j))


@pytest.fixture
def mega_on(monkeypatch):
    monkeypatch.setattr(jph, "USE_MEGA_TABLES", True)
    monkeypatch.setattr(tph, "USE_MEGA_TABLES", True)


def _port(v, p, pyr):
    return (
        convert.variables_from_numpy(jax.tree.map(np.asarray, v), device="cpu"),
        convert.problem_from_numpy(jax.tree.map(np.asarray, p), device="cpu"),
        convert.camera_pyramid_from_numpy(pyr),
    )


def test_mega_photometric_path_matches_plain_and_jax(monkeypatch):
    """test_mega_photometric_path_matches_plain in the port: the mega path's
    linearize against the per-level path's (rtol 1e-5, atol 1e-6 max|H|,
    error 1e-6 relative), and against JAX's mega path at test_torch_ba's
    linearize tolerances; JAX's mega tables carried over by convert equal
    the port's; slicing or compacting the problem drops them."""
    problem, pyr = build_problem()
    v = perturbed_vars(3, 4)
    tv, tp, tpyr = _port(v, problem, pyr)
    cfg = MapperConfig()
    p_plain = tba.prepare_problem(tp, tpyr)
    assert p_plain.window.mega_fg is None
    h0, b0, e0 = tba.linearize(tv, p_plain, tpyr, cfg)
    monkeypatch.setattr(tph, "USE_MEGA_TABLES", True)
    monkeypatch.setattr(jph, "USE_MEGA_TABLES", True)
    p_mega = tba.prepare_problem(tp, tpyr)
    assert p_mega.window.mega_fg is not None
    h1, b1, e1 = tba.linearize(tv, p_mega, tpyr, cfg)
    scale = float(h0.abs().max())
    np.testing.assert_allclose(h1.numpy(), h0.numpy(), rtol=1e-5, atol=1e-6 * scale)
    np.testing.assert_allclose(b1.numpy(), b0.numpy(), rtol=1e-5, atol=1e-6 * scale)
    np.testing.assert_allclose(float(e1), float(e0), rtol=1e-6)
    np.testing.assert_allclose(float(tba.total_error(tv, p_mega, tpyr, cfg)),
                               float(tba.total_error(tv, p_plain, tpyr, cfg)), rtol=1e-6)

    pj = jba.prepare_problem(problem, pyr)
    jcfg = JMapperConfig()
    h_j, b_j, e_j = jax.jit(lambda x: jba.linearize(x, pj, pyr, jcfg))(v)
    scale_j = float(jnp.max(jnp.abs(h_j)))
    np.testing.assert_allclose(h1.numpy(), np.asarray(h_j), rtol=1e-4, atol=1e-5 * scale_j)
    np.testing.assert_allclose(b1.numpy(), np.asarray(b_j), rtol=1e-4, atol=1e-5 * scale_j)
    np.testing.assert_allclose(float(e1), float(e_j), rtol=1e-5)
    carried = convert.problem_from_numpy(jax.tree.map(np.asarray, pj), device="cpu")
    np.testing.assert_array_equal(carried.window.mega_fg.numpy(), p_mega.window.mega_fg.numpy())
    np.testing.assert_array_equal(carried.window.mega_feat.numpy(),
                                  p_mega.window.mega_feat.numpy())
    assert tba.slice_problem_keyframes(p_mega, 2, tpyr).window.mega_fg is None
    ids = torch.tensor([0, 1])
    assert tba.compact_problem_keyframes(p_mega, ids, torch.ones(2), tpyr).window.mega_feat is None

    # run_ba through the mega path: same iterations as the per-level path;
    # both errors converge to ~5e-6 from O(1), where the float32 roundoff
    # of the sums is ~1e-9 (test_sharded_ba.py's atol argument)
    out_m = tba.run_ba(tv, p_mega, tpyr, cfg, torch.ones(3), max_iters=4)
    out_p = tba.run_ba(tv, p_plain, tpyr, cfg, torch.ones(3), max_iters=4)
    assert out_m[2] == out_p[2]
    np.testing.assert_allclose(float(out_m[1]), float(out_p[1]), rtol=1e-4, atol=1e-8)
    np.testing.assert_allclose(out_m[0].pose.trans.numpy(), out_p[0].pose.trans.numpy(), atol=1e-6)


@pytest.mark.parametrize("soft", [False, True], ids=["binary", "soft"])
def test_mega_tracker_terms_match_jax(mega_on, soft):
    """The tracker's photometric terms with the mega tables on, against
    JAX's with them on and the port's with them off (the tolerances of
    test_tracker_photo_terms_match_jax); lm_track's result equals the
    per-level one."""
    scene = Scene()
    jt = scene.jtarget.with_packed(scene.jpyr)
    tt = scene.ttarget.with_packed(scene.tpyr)
    assert tt.mega_fg is not None and jt.mega_fg is not None
    np.testing.assert_array_equal(tt.mega_fg.numpy(), np.asarray(jt.mega_fg))
    np.testing.assert_array_equal(tt.mega_feat.numpy(), np.asarray(jt.mega_feat))
    assert tt.with_packed(scene.tpyr) is tt
    jr, jtr, tr, ttr = _pose([0.08, -0.05, 0.03, 0.02, -0.04, 0.03])
    w = (10.0, 9.0, 8.0, 7.0)
    j = jtracker.tracker_photo_jac_error(jr, jtr, scene.jref, jt, scene.jpyr, w, EPS, soft=soft)
    t = ttracker.tracker_photo_jac_error(tr, ttr, scene.tref, tt, scene.tpyr, w, EPS, soft=soft)
    plain = tt._replace(mega_fg=None, mega_feat=None)  # the per-level tables
    t_off = ttracker.tracker_photo_jac_error(tr, ttr, scene.tref, plain, scene.tpyr, w, EPS,
                                             soft=soft)
    scale = float(np.abs(np.asarray(j[0])).max())
    for ref, rtol in ((j, 1e-4), (t_off, 1e-5)):
        np.testing.assert_allclose(t[0].numpy(), np.asarray(ref[0]), rtol=rtol, atol=1e-6 * scale)
        np.testing.assert_allclose(t[1].numpy(), np.asarray(ref[1]), rtol=rtol, atol=1e-6 * scale)
        np.testing.assert_allclose(float(t[2]), float(ref[2]), rtol=1e-5)
    e_j = jtracker.tracker_photo_error(jr, jtr, scene.jref, jt, scene.jpyr, w, EPS, soft=soft)
    e_t = ttracker.tracker_photo_error(tr, ttr, scene.tref, tt, scene.tpyr, w, EPS, soft=soft)
    np.testing.assert_allclose(float(e_t[0]), float(e_j[0]), rtol=1e-5)
    np.testing.assert_allclose(float(e_t[1]), float(e_j[1]), rtol=1e-5)
    _, _, r0, t0 = _pose(TAU)
    cfg = TrackerConfig(soft_inlier_gate=soft)
    out_m = ttracker.lm_track(r0, t0, scene.tref, tt, scene.tpyr, cfg, max_iters=6)
    out_p = ttracker.lm_track(r0, t0, scene.tref, plain, scene.tpyr, cfg, max_iters=6)
    assert out_m.iterations == out_p.iterations
    np.testing.assert_allclose(out_m.trans.numpy(), out_p.trans.numpy(), atol=1e-6)
    np.testing.assert_allclose(float(out_m.error), float(out_p.error), rtol=1e-5)
