"""Port parity of eval/tsdf.py against the JAX package (CPU).

integrate() on tests/test_tsdf.py's plane cases and on a random depth map,
mask and pose; the host numpy steps (marching_tetrahedra, extract_points,
save_ply) on JAX's own volume carried over by convert; fly_through; and
fuse_keyframes on a tiny mapper state built from JAX's frames. Then the
port's counterparts of test_tsdf.py's four TSDF tests.

integrate() is held to 1e-5 on the voxels away from a rounding boundary
(tsdf.near_rounding_boundary: a projection within 1e-3 px of a half pixel,
or an SDF within 1e-5 of the truncation limit), where one float32 ulp of
the camera-frame point may pick the neighbouring pixel; the voxels that
differ there are counted and held to 0.1% of the volume."""

import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sage_slam_tpu.eval import tsdf as jtsdf
from sage_slam_tpu.geometry.camera import PinholeCamera as JCam
from sage_slam_tpu.geometry.se3 import SE3 as JSE3
from sage_slam_tpu.geometry.se3 import se3_exp as jse3_exp
from sage_slam_tpu_torch import convert
from sage_slam_tpu_torch.eval import tsdf
from sage_slam_tpu_torch.geometry.camera import PinholeCamera
from sage_slam_tpu_torch.geometry.se3 import SE3

torch.set_num_threads(1)

FLIP_SHARE = 1e-3  # voxels that may differ next to a rounding boundary


def _cams(h, w, f, cx, cy):
    return PinholeCamera(f, f, cx, cy, w, h), JCam(fx=f, fy=f, cx=cx, cy=cy, width=w, height=h)


def _pose(tau=None):
    """(port SE3, JAX SE3) of se3_exp(tau) taken in JAX, identity for None."""
    jp = JSE3.identity() if tau is None else jse3_exp(jnp.asarray(tau, jnp.float32))
    rot, trans = np.array(jp.rot), np.array(jp.trans)
    return SE3(torch.from_numpy(rot), torch.from_numpy(trans)), jp


def _integrate_both(case):
    """(port volume, JAX volume, near-boundary mask) after integrating the
    case's depth maps in order."""
    tcam, jcam = _cams(*case["cam"])
    tv = tsdf.TSDFVolume.create(case["origin"], case["dims"], case["voxel"], device="cpu")
    jv = jtsdf.TSDFVolume.create(case["origin"], case["dims"], case["voxel"])
    near = np.zeros(case["dims"], bool)
    for depth, mask, tau in case["frames"]:
        tp, jp = _pose(tau)
        near |= tsdf.near_rounding_boundary(tv, depth, tp, tcam)
        tv = tsdf.integrate(tv, depth, mask, tp, tcam)
        jv = jtsdf.integrate(jv, jnp.asarray(depth), jnp.asarray(mask), jp, jcam)
    return tv, jv, near


def _plane(h, w, d):
    return np.full((h, w), d, np.float32), np.ones((h, w), np.float32), None


def _random_frames(seed, h, w, n):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        depth = (0.8 + 0.5 * rng.random((h, w))).astype(np.float32)
        mask = (rng.random((h, w)) > 0.2).astype(np.float32)
        tau = rng.uniform(-0.06, 0.06, 6).astype(np.float32)
        out.append((depth, mask, tau))
    return out


CASES = {
    # tests/test_tsdf.py's four volumes
    "plane_fusion": dict(cam=(32, 40, 40.0, 19.5, 15.5), origin=(-0.5, -0.5, 0.0), dims=(32, 32, 32),
                         voxel=0.05, frames=[_plane(32, 40, 1.0)]),
    "extract": dict(cam=(16, 20, 20.0, 10.0, 8.0), origin=(-0.5, -0.5, 0.0), dims=(16, 16, 16),
                    voxel=0.08, frames=[_plane(16, 20, 0.7)]),
    "fly": dict(cam=(24, 30, 30.0, 14.5, 11.5), origin=(-0.5, -0.5, 0.0), dims=(24, 24, 24),
                voxel=0.07, frames=[_plane(24, 30, 0.9)]),
    # random depth maps, masks and poses, three frames fused
    "random": dict(cam=(32, 40, 40.0, 19.5, 15.5), origin=(-0.6, -0.6, 0.2), dims=(40, 40, 40),
                   voxel=0.035, frames=_random_frames(0, 32, 40, 3)),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def fused(request):
    return request.param, _integrate_both(CASES[request.param])


def test_integrate_matches_jax(fused):
    name, (tv, jv, near) = fused
    t, w = tv.tsdf.numpy(), tv.weight.numpy()
    jt, jw = np.asarray(jv.tsdf), np.asarray(jv.weight)
    assert w.sum() > 0
    far = ~near
    np.testing.assert_allclose(t[far], jt[far], atol=1e-5, err_msg=name)
    np.testing.assert_allclose(w[far], jw[far], atol=1e-5, err_msg=name)
    flipped = int(((np.abs(t - jt) > 1e-5) | (np.abs(w - jw) > 1e-5))[near].sum())
    print(f"{name}: {near.sum()} voxels near a rounding boundary, {flipped} of them differ")
    assert flipped <= FLIP_SHARE * t.size
    np.testing.assert_allclose(tv.origin.numpy(), np.asarray(jv.origin))
    assert (tv.voxel_size, tv.trunc) == (jv.voxel_size, jv.trunc)


def test_host_steps_on_jax_volume_are_identical(fused, tmp_path):
    """marching_tetrahedra, extract_points and save_ply on JAX's own volume
    carried into the port: identical arrays and bytes; the volume survives
    the round trip through convert unchanged."""
    name, (_, jv, _) = fused
    tv = convert.tsdf_volume_from_numpy(jax.tree.map(np.asarray, jv._asdict()), device="cpu")
    back = convert.tsdf_volume_to_numpy(tv)
    for k in ("tsdf", "weight", "origin"):
        assert np.array_equal(back[k], np.asarray(getattr(jv, k))), k
    assert (back["voxel_size"], back["trunc"]) == (jv.voxel_size, jv.trunc)

    verts, faces = tsdf.marching_tetrahedra(tv)
    jverts, jfaces = jtsdf.marching_tetrahedra(jv)
    assert np.array_equal(verts, jverts) and np.array_equal(faces, jfaces), name
    assert np.array_equal(tsdf.extract_points(tv), jtsdf.extract_points(jv))
    assert np.array_equal(tsdf.face_normals(verts, faces), jtsdf.face_normals(jverts, jfaces))
    for label, args, jargs in (("mesh", (verts, faces), (jverts, jfaces)),
                               ("points", (tsdf.extract_points(tv),), (jtsdf.extract_points(jv),))):
        a, b = tmp_path / f"port_{label}.ply", tmp_path / f"jax_{label}.ply"
        tsdf.save_ply(str(a), *args)
        jtsdf.save_ply(str(b), *jargs)
        assert a.read_bytes() == b.read_bytes(), label


@pytest.mark.parametrize("num_frames,point_size", [(4, 1), (8, 2)])
def test_fly_through_matches_jax(num_frames, point_size):
    """Frames along the same waypoints over JAX's random-case volume: equal
    but for at most 1% of the pixels (the tangent-space interpolation runs
    in torch on one side and in XLA on the other)."""
    _, jv, _ = _integrate_both(CASES["random"])
    tv = convert.tsdf_volume_from_numpy(jax.tree.map(np.asarray, jv._asdict()), device="cpu")
    tcam, jcam = _cams(*CASES["random"]["cam"])
    taus = [None] + [f[2] for f in CASES["random"]["frames"]]
    poses = [_pose(t) for t in taus]
    frames = tsdf.fly_through(tv, tcam, [p for p, _ in poses], num_frames, point_size)
    jframes = jtsdf.fly_through(jv, jcam, [p for _, p in poses], num_frames, point_size)
    assert len(frames) == len(jframes) == num_frames
    for fr, jfr in zip(frames, jframes):
        assert fr.shape == jfr.shape and fr.dtype == np.uint8
        differ = np.any(fr != jfr, axis=-1).mean()
        assert differ <= 0.01, differ
        assert int((fr > 0).sum()) > 20


def test_fuse_keyframes_matches_jax():
    """fuse_keyframes on the same keyframe state: the mapper pair of
    tests/test_torch_mapper.py after init and three keyframes (JAX's
    frames carried into the port's store)."""
    from tests.test_torch_mapper import Pair

    pair = Pair()
    pair.init()
    for f in (1, 2, 3):
        pair.add_keyframe(f)
    cam = pair.scene.camera
    jcam = JCam(cam.fx, cam.fy, cam.cx, cam.cy, cam.width, cam.height)
    jv = jtsdf.fuse_keyframes(SimpleNamespace(cam=jcam, store=pair.jm.store, mapper=pair.jm),
                              dims=(24, 24, 24))
    tv = tsdf.fuse_keyframes(SimpleNamespace(cam=cam, store=pair.tm.store, mapper=pair.tm),
                             dims=(24, 24, 24))
    assert tv.tsdf.device.type == "cpu"
    np.testing.assert_allclose(tv.origin.numpy(), np.asarray(jv.origin), rtol=1e-6)
    assert tv.voxel_size == pytest.approx(jv.voxel_size, rel=1e-6)
    t, jt = tv.tsdf.numpy(), np.asarray(jv.tsdf)
    w, jw = tv.weight.numpy(), np.asarray(jv.weight)
    assert w.sum() > 0
    differ = (np.abs(t - jt) > 1e-5) | (w != jw)
    print(f"fuse_keyframes: {int(differ.sum())} of {t.size} voxels differ")
    assert differ.sum() <= FLIP_SHARE * t.size
    np.testing.assert_allclose(t[~differ], jt[~differ], atol=1e-5)


# ---- the port's counterparts of tests/test_tsdf.py ----


def _plane_volume(h, w, f, cx, cy, origin, dims, voxel, depth):
    cam = PinholeCamera(fx=f, fy=f, cx=cx, cy=cy, width=w, height=h)
    vol = tsdf.TSDFVolume.create(origin, dims, voxel, device="cpu")
    vol = tsdf.integrate(vol, torch.full((h, w), depth), torch.ones((h, w)),
                         SE3.identity(), cam)
    return cam, vol


def test_plane_fusion():
    _, vol = _plane_volume(32, 40, 40.0, 19.5, 15.5, (-0.5, -0.5, 0.0), (32, 32, 32), 0.05, 1.0)
    t = vol.tsdf.numpy()
    wgt = vol.weight.numpy()
    assert wgt.sum() > 0
    zc = t[16, 16, :]
    observed = wgt[16, 16, :] > 0
    assert observed.any()
    assert zc[observed & (np.arange(32) * 0.05 < 0.9)].min() > 0.5
    near = np.abs(np.arange(32) * 0.05 - 1.0) < 0.05
    assert np.abs(zc[near & observed]).max() < 0.5


def test_extract_and_save(tmp_path):
    _, vol = _plane_volume(16, 20, 20.0, 10.0, 8.0, (-0.5, -0.5, 0.0), (16, 16, 16), 0.08, 0.7)
    pts = tsdf.extract_points(vol)
    assert len(pts) > 0
    path = os.path.join(tmp_path, "mesh.ply")
    tsdf.save_ply(path, pts)
    assert os.path.getsize(path) > 100


def test_marching_tetrahedra_plane(tmp_path):
    _, vol = _plane_volume(32, 40, 40.0, 19.5, 15.5, (-0.5, -0.5, 0.0), (32, 32, 32), 0.05, 1.0)
    verts, faces = tsdf.marching_tetrahedra(vol)
    assert len(verts) > 50 and len(faces) > 50
    assert faces.max() < len(verts)
    assert np.abs(verts[:, 2] - 1.0).max() < 0.15
    n = tsdf.face_normals(verts, faces)
    assert np.abs(n[:, 2]).mean() > 0.9
    path = os.path.join(tmp_path, "mesh.ply")
    tsdf.save_ply(path, verts, faces)
    head = open(path).read(400)
    assert "element face" in head and "vertex_indices" in head


def test_fly_through_renders_frames():
    cam, vol = _plane_volume(24, 30, 30.0, 14.5, 11.5, (-0.5, -0.5, 0.0), (24, 24, 24), 0.07, 0.9)
    poses = [SE3.identity(), SE3(torch.eye(3), torch.tensor([0.1, 0.0, -0.1]))]
    frames = tsdf.fly_through(vol, cam, poses, num_frames=4)
    assert len(frames) == 4
    for fr in frames:
        assert fr.shape == (24, 30, 3) and fr.dtype == np.uint8
    assert all(int((fr > 0).sum()) > 20 for fr in frames)


def test_create_raises_without_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tsdf.TSDFVolume.create((0, 0, 0), (4, 4, 4), 0.1)
    assert tsdf.TSDFVolume.create((0, 0, 0), (4, 4, 4), 0.1, device="cpu").tsdf.device.type == "cpu"
