"""Port parity: SE(3), cameras, interpolation and pyramids against the JAX
package on the same numpy inputs (CPU, float32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sage_slam_tpu.geometry import camera as jcam
from sage_slam_tpu.geometry import interp as jinterp
from sage_slam_tpu.geometry import se3 as jse3
from sage_slam_tpu.ops import pyramid as jpyr
from sage_slam_tpu_torch.geometry import camera as tcam
from sage_slam_tpu_torch.geometry import interp as tinterp
from sage_slam_tpu_torch.geometry import se3 as tse3
from sage_slam_tpu_torch.ops import pyramid as tpyr

torch.set_num_threads(1)

# float32 transcendental / matmul roundoff on O(1) values
TOL = dict(rtol=1e-5, atol=2e-6)


def _t(x):
    return torch.from_numpy(np.array(x))


def _taus(seed=0, n=16):
    rng = np.random.default_rng(seed)
    taus = (rng.standard_normal((n, 6)) * 0.7).astype(np.float32)
    taus[0] = 0.0  # exact zero tangent
    taus[1, 3:] = [1e-5, -2e-5, 3e-6]  # small-angle series branch
    taus[2, 3:] = [np.pi - 1e-4, 0.0, 0.0]  # near-pi log branch
    taus[3, 3:] = [0.0, -(np.pi - 5e-4), 1e-4]
    return taus


def test_se3_exp_log_compose_match_jax():
    taus = _taus()
    tj = jnp.asarray(taus)
    tt = _t(taus)
    pj = jse3.se3_exp(tj)
    pt = tse3.se3_exp(tt)
    np.testing.assert_allclose(pt.rot.numpy(), np.asarray(pj.rot), **TOL)
    np.testing.assert_allclose(pt.trans.numpy(), np.asarray(pj.trans), **TOL)
    np.testing.assert_allclose(
        tse3.so3_exp(tt[:, 3:]).numpy(), np.asarray(jse3.so3_exp(tj[:, 3:])), **TOL
    )
    # near-pi logs are ill-conditioned in float32: 1e-3 absolute
    np.testing.assert_allclose(
        tse3.so3_log(pt.rot).numpy(), np.asarray(jse3.so3_log(pj.rot)),
        rtol=1e-4, atol=1e-3,
    )
    np.testing.assert_allclose(
        tse3.se3_log(pt).numpy(), np.asarray(jse3.se3_log(pj)), rtol=1e-4, atol=1e-3
    )
    qj = jse3.se3_exp(tj[::-1] * 0.3)
    qt = tse3.se3_exp(torch.flip(tt, [0]) * 0.3)
    for fj, ft in (
        (jse3.compose, tse3.compose),
        (jse3.relative_pose, tse3.relative_pose),
    ):
        rj, rt = fj(pj, qj), ft(pt, qt)
        np.testing.assert_allclose(rt.rot.numpy(), np.asarray(rj.rot), **TOL)
        np.testing.assert_allclose(rt.trans.numpy(), np.asarray(rj.trans), **TOL)
    rj = jse3.retract(pj, tj[::-1] * 0.1)
    rt = tse3.retract(pt, torch.flip(tt, [0]) * 0.1)
    np.testing.assert_allclose(rt.rot.numpy(), np.asarray(rj.rot), **TOL)
    np.testing.assert_allclose(rt.trans.numpy(), np.asarray(rj.trans), **TOL)
    np.testing.assert_allclose(
        tse3.local(pt, qt).numpy(), np.asarray(jse3.local(pj, qj)), rtol=1e-4, atol=1e-3
    )
    np.testing.assert_allclose(
        tse3.pose_distance(pt, qt).numpy(), np.asarray(jse3.pose_distance(pj, qj)),
        rtol=1e-4, atol=1e-3,
    )
    x = np.random.default_rng(1).standard_normal((16, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tse3.act(pt, _t(x)).numpy(), np.asarray(jse3.act(pj, jnp.asarray(x))), **TOL
    )
    inv_t = tse3.inverse(pt)
    np.testing.assert_allclose(
        inv_t.trans.numpy(), np.asarray(jse3.inverse(pj).trans), **TOL
    )
    np.testing.assert_allclose(
        tse3.hat(tt[:, 3:]).numpy(), np.asarray(jse3.hat(tj[:, 3:])), atol=0
    )
    ident = tse3.SE3.identity((2,))
    np.testing.assert_array_equal(
        ident.matrix().numpy(), np.asarray(jse3.SE3.identity((2,)).matrix())
    )


def test_camera_pyramid_offsets_match_jax():
    cam_j = jcam.PinholeCamera(fx=88.0, fy=88.0, cx=39.5, cy=31.5, width=80, height=64)
    cam_t = tcam.PinholeCamera(fx=88.0, fy=88.0, cx=39.5, cy=31.5, width=80, height=64)
    pj = jcam.CameraPyramid.build(cam_j, 4)
    pt = tcam.CameraPyramid.build(cam_t, 4)
    assert pt.level_offsets == pj.level_offsets
    assert pt.quad_level_offsets == pj.quad_level_offsets
    assert pt.total_quad_rows == pj.total_quad_rows
    assert pt.total_pixels == pj.total_pixels
    for a, b in zip(pt.cameras, pj.cameras):
        assert dataclass_tuple(a) == dataclass_tuple(b)


def dataclass_tuple(cam):
    return (cam.fx, cam.fy, cam.cx, cam.cy, cam.width, cam.height)


W, H, C = 9, 7, 3


def _knife_coords():
    """Exact integer and .5 fractions, the image borders, out-of-image and
    huge coordinates (the float->int cast must not misbehave)."""
    rng = np.random.default_rng(3)
    x = np.concatenate([
        rng.uniform(-2.0, W + 1.0, 64),
        [0.0, 0.5, 1.5, W - 1.0, W - 0.5, W - 1.5, -0.5, -1.0, -1.5, W, W + 0.5,
         2.5, 3.0, 1e7, -1e7, 4.5, 0.25],
    ]).astype(np.float32)
    y = np.concatenate([
        rng.uniform(-2.0, H + 1.0, 64),
        [0.5, 0.0, 2.5, H - 1.0, H - 0.5, -0.5, H - 1.5, 3.0, -1e7, H + 0.5,
         1.5, 1e7, 0.5, 2.0, 3.0, H - 1.0, 6.5],
    ]).astype(np.float32)
    return x, y


def _image(rows=2 * H * W):
    rng = np.random.default_rng(4)
    return rng.standard_normal((C, rows)).astype(np.float32)


@pytest.mark.parametrize("offset", [0, H * W])
def test_flat_samplers_match_jax(offset):
    img = _image()
    x, y = _knife_coords()
    for fj, ft in (
        (jinterp.bilinear_flat, tinterp.bilinear_flat),
        (jinterp.nearest_flat, tinterp.nearest_flat),
    ):
        out_j = np.asarray(fj(jnp.asarray(img), jnp.asarray(x), jnp.asarray(y), W, H, offset))
        out_t = ft(_t(img), _t(x), _t(y), W, H, offset).numpy()
        np.testing.assert_allclose(out_t, out_j, rtol=1e-6, atol=1e-6)
    # 1-D table (the validity mask)
    out_j = np.asarray(jinterp.nearest_flat(jnp.asarray(img[0]), jnp.asarray(x), jnp.asarray(y), W, H, offset))
    out_t = tinterp.nearest_flat(_t(img[0]), _t(x), _t(y), W, H, offset).numpy()
    np.testing.assert_array_equal(out_t, out_j)


def test_quad_samplers_match_jax():
    img = _image(H * W)  # [C, M]
    rows = img.T  # [M, C]
    x, y = _knife_coords()
    xj, yj, xt, yt = jnp.asarray(x), jnp.asarray(y), _t(x), _t(y)
    pj = jinterp.pack_quads_level(jnp.asarray(rows), W)
    pt = tinterp.pack_quads_level(_t(rows), W)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_allclose(
        tinterp.bilinear_quad(pt, xt, yt, W, H).numpy(),
        np.asarray(jinterp.bilinear_quad(pj, xj, yj, W, H)), rtol=1e-6, atol=1e-6,
    )
    ptT, pjT = pt.T.contiguous(), pj.T
    rowv_j, wj = jinterp.quad_gather_cols(pjT, xj, yj, W, H)
    rowv_t, wt = tinterp.quad_gather_cols(ptT, xt, yt, W, H)
    np.testing.assert_array_equal(rowv_t.numpy(), np.asarray(rowv_j))
    for a, b in zip(wt, wj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(
        tinterp.combine_quad_cm(rowv_t, wt, C - 1, C).numpy(),
        np.asarray(jinterp.combine_quad_cm(rowv_j, wj, C - 1, C)), rtol=1e-6, atol=1e-6,
    )
    np.testing.assert_allclose(
        tinterp.quad_bilinear_select_cm(rowv_t, wt, C - 1, C).numpy(),
        np.asarray(jinterp.quad_bilinear_select_cm(rowv_j, wj, C - 1, C)),
        rtol=1e-6, atol=1e-6,
    )
    # nearest select rounds half-up, nearest_flat half-to-even: port each
    np.testing.assert_array_equal(
        tinterp.quad_nearest_select_cm(rowv_t, xt, yt, W, H, C - 1, C).numpy(),
        np.asarray(jinterp.quad_nearest_select_cm(rowv_j, xj, yj, W, H, C - 1, C)),
    )
    # batched [E, N] coordinates with per-edge offsets
    xb, yb = torch.stack([xt, xt * 0.5]), torch.stack([yt, yt * 0.5])
    rowv_b, _ = tinterp.quad_gather_cols(
        torch.cat([ptT, ptT], 1), xb, yb, W, H, torch.tensor([0, pt.shape[0]])
    )
    rowv_1, _ = jinterp.quad_gather_cols(pjT, xj * 0.5, yj * 0.5, W, H)
    np.testing.assert_array_equal(rowv_b[1].numpy(), np.asarray(rowv_1))


def test_dense_bilinear_and_locations_match_jax():
    img = _image(H * W)
    x, y = _knife_coords()
    keep = np.abs(x) < 100  # huge coordinates: both give 0, skip the 1e7 hats
    x, y = x[keep], y[keep]
    np.testing.assert_allclose(
        tinterp.dense_bilinear_cm(_t(img), _t(x), _t(y), W, H).numpy(),
        np.asarray(jinterp.dense_bilinear_cm(jnp.asarray(img), jnp.asarray(x), jnp.asarray(y), W, H)),
        rtol=1e-5, atol=1e-6,
    )
    # dense hats equal the quad bilinear up to float32 roundoff
    np.testing.assert_allclose(
        tinterp.dense_bilinear_cm(_t(img), _t(x), _t(y), W, H).numpy(),
        tinterp.bilinear_flat(_t(img), _t(x), _t(y), W, H).numpy(), rtol=1e-5, atol=1e-6,
    )
    loc = np.array([0, 1, W - 1, W, W * H - 1, 17], np.int32)
    cam_j = jcam.PinholeCamera(fx=10.0, fy=11.0, cx=4.0, cy=3.0, width=W, height=H)
    cam_t = tcam.PinholeCamera(fx=10.0, fy=11.0, cx=4.0, cy=3.0, width=W, height=H)
    np.testing.assert_allclose(
        tinterp.locations_1d_to_homo(_t(loc), cam_t).numpy(),
        np.asarray(jinterp.locations_1d_to_homo(jnp.asarray(loc), cam_j)), atol=1e-7,
    )
    lx, ly = tinterp.level_coords(_t(x), _t(y), 0.5, 0.25)
    jx, jy = jinterp.level_coords(jnp.asarray(x), jnp.asarray(y), 0.5, 0.25)
    np.testing.assert_array_equal(lx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ly.numpy(), np.asarray(jy))


def test_valid_locations_exact():
    rng = np.random.default_rng(3)
    h, w = 12, 17
    mask = (rng.random(h * w) > 0.4).astype(np.float32)
    fx, fy, cx, cy = 18.7, 19.1, 8.0, 5.5
    homo_j, valid_j = jinterp.valid_locations(jnp.asarray(mask), w, fx, fy, cx, cy)
    homo_t, valid_t = tinterp.valid_locations(torch.from_numpy(mask), w, fx, fy, cx, cy)
    np.testing.assert_array_equal(homo_t.numpy(), np.asarray(homo_j))
    np.testing.assert_array_equal(valid_t.numpy(), np.asarray(valid_j))


def test_pyramid_matches_jax():
    rng = np.random.default_rng(5)
    feat = rng.standard_normal((4, 32, 40)).astype(np.float32)
    mask = (rng.random((32, 40)) > 0.2).astype(np.float32)
    mj = jpyr.mask_pyramid(jnp.asarray(mask), 4)
    mt = tpyr.mask_pyramid(_t(mask), 4)
    for a, b in zip(mt, mj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    fj, gj = jpyr.gaussian_pyramid_with_grad(jnp.asarray(feat), mj, 4)
    ft, gt = tpyr.gaussian_pyramid_with_grad(_t(feat), mt, 4)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(
        tpyr.spatial_grad(_t(feat)).numpy(), np.asarray(jpyr.spatial_grad(jnp.asarray(feat)))
    )
