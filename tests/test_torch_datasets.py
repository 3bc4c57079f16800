"""Port parity of the dataset readers: sage_slam_tpu_torch.io.dataset against
sage_slam_tpu.io.dataset on the same files and arguments.

Every image, depth, pose, mask and timestamp is np.array_equal to JAX's
(the port's readers are the same numpy code); intrinsics are equal
floats; from_url gives the same reader values, and the same exception type
and message for a bad URL."""

import os

import h5py
import numpy as np
import pytest
import torch

from sage_slam_tpu.io import dataset as jds
from sage_slam_tpu_torch.geometry.camera import PinholeCamera
from sage_slam_tpu_torch.io import dataset as tds
from tests.test_datasets import _make_icl, _make_scannet, _write_color

torch.set_num_threads(1)


def assert_same_camera(t, j):
    assert isinstance(t, PinholeCamera)
    assert (t.fx, t.fy, t.cx, t.cy, t.width, t.height) == (j.fx, j.fy, j.cx, j.cy, j.width, j.height)


def assert_same_frames(tr, jr, limit=None):
    assert_same_camera(tr.intrinsics(), jr.intrinsics())
    np.testing.assert_array_equal(tr.mask(), jr.mask())
    tf, jf = list(tr.frames())[:limit], list(jr.frames())[:limit]
    assert len(tf) == len(jf) > 0
    for a, b in zip(tf, jf):
        assert isinstance(a, tds.FrameRecord)
        assert a.timestamp == b.timestamp
        assert a.image.dtype == b.image.dtype
        np.testing.assert_array_equal(a.image, b.image)
        for name in ("depth", "pose_wf"):
            x, y = getattr(a, name), getattr(b, name)
            assert (x is None) == (y is None), name
            if x is not None:
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
    return tf


def test_icl_reader_matches_jax(tmp_path):
    root = str(tmp_path / "icl")
    _make_icl(root)
    frames = assert_same_frames(tds.from_url(f"icl://{root}"), jds.from_url(f"icl://{root}"))
    assert len(frames) == 2
    assert_same_frames(tds.IclInterface(root, stride=2), jds.IclInterface(root, stride=2))


@pytest.mark.parametrize("resize", [False, True])
def test_scannet_reader_matches_jax(tmp_path, resize):
    root = str(tmp_path / "scan")
    _make_scannet(root)
    assert_same_frames(tds.from_url(f"scannet://{root}", resize=resize),
                       jds.from_url(f"scannet://{root}", resize=resize))


def _color_stack(n=4, h=24, w=32):
    return (np.random.default_rng(5).random((n, h, w, 3)) * 255).astype(np.uint8)


def test_hdf5_reader_matches_jax(tmp_path):
    path = str(tmp_path / "fusion_data.hdf5")
    with h5py.File(path, "w") as f:
        f["color"] = _color_stack()
        f["mask"] = (np.random.default_rng(6).random((24, 32, 1)) > 0.2).astype(np.uint8)
        f["intrinsics"] = np.array([30.0, 31.0, 15.5, 11.5])
    assert_same_frames(tds.from_url(f"hdf5://{path}"), jds.from_url(f"hdf5://{path}"))
    assert_same_frames(tds.from_url(f"hdf5://{path}", stride=3), jds.from_url(f"hdf5://{path}", stride=3))


@pytest.mark.parametrize("as_float", [False, True])
def test_npz_reader_matches_jax(tmp_path, as_float):
    path = str(tmp_path / "seq.npz")
    color = _color_stack()
    if as_float:
        color = color.astype(np.float32) / 255.0
    np.savez(path, color=color, mask=np.ones((24, 32)), intrinsics=np.array([30.0, 31.0, 15.5, 11.5]),
             timestamps=np.arange(4) * 0.5)
    assert_same_frames(tds.NpzInterface(path), jds.NpzInterface(path))
    assert_same_frames(tds.NpzInterface(path, stride=2), jds.NpzInterface(path, stride=2))


def test_tum_reader_matches_jax(tmp_path):
    root = tmp_path / "tum"
    (root / "rgb").mkdir(parents=True)
    lines = ["# timestamp filename"]
    for i in range(3):
        _write_color(str(root / "rgb" / f"{i}.png"), seed=i)
        lines.append(f"{100 + 0.033 * i:.6f} rgb/{i}.png")
    (root / "rgb.txt").write_text("\n".join(lines) + "\n")
    assert_same_frames(tds.from_url(f"tum://{root}"), jds.from_url(f"tum://{root}"))
    intr = (30.0, 31.0, 15.5, 11.5, 32, 24)
    assert_same_frames(tds.TumInterface(str(root), intr), jds.TumInterface(str(root), intr))


@pytest.mark.parametrize("kwargs", [
    dict(), dict(num_frames=5, height=32, width=40, seed=3, motion_scale=0.02),
])
def test_synthetic_matches_jax(kwargs):
    assert_same_frames(tds.SyntheticInterface(**kwargs), jds.SyntheticInterface(**kwargs))
    assert_same_frames(tds.from_url("synthetic://", **kwargs), jds.from_url("synthetic://", **kwargs))


BOWL = {
    "default": dict(num_frames=6, height=32, width=40, seed=0),
    "eval orbit": dict(num_frames=5, height=32, width=40, seed=0, orbit_radius=0.22, rot_amp=0.25,
                       mask_margin=6),
    "hard mode": dict(num_frames=4, height=24, width=32, seed=1, light_falloff=0.5, specular=0.3,
                      noise=0.01, mask_margin=2),
    "multi orbit": dict(num_frames=7, height=16, width=20, seed=0, orbits=3.0, orbit_radius=0.2,
                        rot_amp=0.2),
    "no revisit": dict(num_frames=4, height=16, width=20, seed=2, revisit=False, focal=0.9),
}


@pytest.mark.parametrize("name", list(BOWL))
def test_bowl3d_matches_jax(name):
    kw = BOWL[name]
    t, j = tds.Bowl3DInterface(**kw), jds.Bowl3DInterface(**kw)
    assert_same_frames(t, j)
    for i in range(kw["num_frames"]):
        np.testing.assert_array_equal(t.pose_at(i), j.pose_at(i))
    for a, b in zip(t.render(2, 12, 20), j.render(2, 12, 20)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t.mask(12, 20), j.mask(12, 20))
    ta, ja = t.to_arrays(), j.to_arrays(12, 16)
    ta2 = t.to_arrays(12, 16)
    assert sorted(ta) == sorted(ja)
    for key in ta2:
        assert ta2[key].dtype == ja[key].dtype, key
        np.testing.assert_array_equal(ta2[key], ja[key], err_msg=key)
    np.testing.assert_array_equal(ta["color"], j.to_arrays()["color"])


URLS = [
    "bowl3d://?num_frames=7&orbit_radius=0.33&mask_margin=4",
    "bowl3d://?num_frames=31&height=16&width=20&orbits=2.0",
    "bowl3d://?num_frames=3&revisit=false&light_falloff=0.5&specular=0.2&noise=0.005",
    "bowl3d://?num_frames=64&height=128&width=160&seed=0&orbit_radius=0.22&rot_amp=0.25&mask_margin=6",
    "bowl3d://?num_frames=4&focal=1e-1&revisit=TRUE",
]


@pytest.mark.parametrize("url", URLS)
def test_from_url_bowl3d_matches_jax(url):
    defaults = dict(num_frames=99, height=32, width=40)
    t, j = tds.from_url(url, **defaults), jds.from_url(url, **defaults)
    names = ("n", "h", "w", "z0", "radius", "r_orbit", "rot_amp", "revisit", "mask_margin", "orbits",
             "light_falloff", "specular", "spec_power", "noise", "_seed")
    assert [getattr(t, k) for k in names] == [getattr(j, k) for k in names]
    assert_same_camera(t.intrinsics(), j.intrinsics())
    np.testing.assert_array_equal(t.mask(), j.mask())
    np.testing.assert_array_equal(t.pose_at(1), j.pose_at(1))


BAD_URLS = [
    ("bowl3d://?num_frames=abc", {}),
    ("bowl3d://?revisit=maybe", {}),
    ("ftp://nowhere", {}),
    ("bowl3d://?orbit_radius=1.5", dict(num_frames=3, height=8, width=10)),  # leaves the cavity
    ("bowl3d://?no_such_arg=1", {}),
]


@pytest.mark.parametrize("url,kwargs", BAD_URLS)
def test_from_url_errors_match_jax(url, kwargs):
    errors = []
    for mod in (tds, jds):
        with pytest.raises(Exception) as info:
            list(mod.from_url(url, **kwargs).frames())
        errors.append(info.value)
    assert type(errors[0]) is type(errors[1])
    assert str(errors[0]) == str(errors[1])


def test_missing_reader_dependency_is_lazy():
    """Importing the module needs neither PIL nor h5py: both are imported
    inside the readers."""
    src = open(tds.__file__).read()
    top = [ln for ln in src.splitlines() if ln.startswith(("import ", "from "))]
    assert not any("PIL" in ln or "h5py" in ln for ln in top), top
    assert os.path.basename(tds.__file__) == "dataset.py"
