"""Port parity of SlamDriver.run over prebuilt frames and of the headless
viewers (viz/visualizer, viz/warp_display).

* SlamDriver(use_native_threads=False).run(frames=) with JAX's frames and
  keypoints follows JAX's driver (frontend/driver.SlamDriver, threadless)
  within tests/test_torch_slam.py's tolerances: per frame equal keyframe
  decisions and poses within 1e-4; at the end equal refine iterations,
  links and loop-search flags, keyframe translations 1e-4, scales rtol
  1e-4, finalized poses 1e-4;
* keyframe_point_cloud, frustum_lines and se3_warp_image agree with JAX's
  on the same state (JAX's checkpoint loaded into the port) to rtol 1e-5,
  atol 1e-6."""

import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sage_slam_tpu.frontend.driver import SlamDriver as JDriver
from sage_slam_tpu.mapping import serialize as jser
from sage_slam_tpu.viz import visualizer as jviz
from sage_slam_tpu.viz import warp_display as jwarp
from sage_slam_tpu_torch import convert
from sage_slam_tpu_torch.frontend.driver import SlamDriver
from sage_slam_tpu_torch.geometry.se3 import relative_pose
from sage_slam_tpu_torch.mapping import serialize as tser
from sage_slam_tpu_torch.viz import visualizer as tviz
from sage_slam_tpu_torch.viz import warp_display as twarp
from tests.test_torch_slam import jax_tiny_system, port_system, record_frames

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def driven(tmp_path_factory):
    """JAX's threadless driver over tiny_system's frames, then the port's
    over the frames JAX built (run(frames=)); JAX's state saved and loaded
    into a fresh port system."""
    jsys, data = jax_tiny_system()
    tsys = port_system(jsys)
    built = record_frames(jsys)
    j_results = JDriver(jsys, use_native_threads=False).run(data)
    frames = [convert.frame_from_numpy(built[ts], device="cpu") for ts in sorted(built)]
    t_results = SlamDriver(tsys, use_native_threads=False).run(frames=frames)
    path = str(tmp_path_factory.mktemp("state") / "jax.npz")
    jser.save_state(path, jsys)
    same = port_system(jsys)
    tser.load_state(path, same)
    return jsys, tsys, j_results, t_results, same


def _pose_close(tp, jp, atol):
    np.testing.assert_allclose(tp.rot.numpy(), np.asarray(jp.rot), atol=atol)
    np.testing.assert_allclose(tp.trans.numpy(), np.asarray(jp.trans), atol=atol)


def test_driver_over_prebuilt_frames_follows_jax(driven):
    jsys, tsys, j_results, t_results, _ = driven
    assert len(t_results) == len(j_results) == 7
    for f, (rj, rt) in enumerate(zip(j_results, t_results), start=1):
        assert (rt.new_keyframe, rt.keyframe_id) == (rj.new_keyframe, rj.keyframe_id), f"frame {f}"
        _pose_close(rt.pose, rj.pose, 1e-4)
    n = tsys.store.num_active
    assert n == jsys.store.num_active >= 2
    assert tsys.refine_iterations == jsys.refine_iterations
    assert tsys.store.links == jsys.store.links
    jv = jax.tree.map(np.asarray, jsys.store.variables)
    np.testing.assert_allclose(tsys.store.variables.pose.trans[:n].numpy(), jv.pose.trans[:n], atol=1e-4)
    np.testing.assert_allclose(tsys.store.variables.scale[:n].numpy(), jv.scale[:n], rtol=1e-4)
    for (ts_t, p_t), (ts_j, p_j) in zip(tsys.finalized_trajectory(), jsys.finalized_trajectory()):
        assert ts_t == ts_j
        _pose_close(p_t, p_j, 1e-4)
    for name in ("local_loop_searched", "global_loop_searched"):
        np.testing.assert_array_equal(getattr(tsys.store, name), getattr(jsys.store, name))
    assert tsys.store.local_loop_searched[:n].all()  # the drain searched every keyframe
    with pytest.raises(ValueError):
        SlamDriver(tsys, use_native_threads=False).run()


def test_viewers_match_jax_on_the_same_state(driven, tmp_path):
    """JAX's state loaded into the port: point clouds, frustums and the SE3
    warp agree to rtol 1e-5 (atol 1e-6 for values near 0)."""
    jsys, _, _, _, same = driven
    n = same.store.num_active
    for kf in range(n):
        for stride in (1, 3):
            np.testing.assert_allclose(tviz.keyframe_point_cloud(same, kf, stride),
                                       jviz.keyframe_point_cloud(jsys, kf, stride), rtol=1e-5, atol=1e-6)
        for a, b in zip(tviz.frustum_lines(same.store.pose(kf), same.cam, 0.2),
                        jviz.frustum_lines(jsys.store.pose(kf), jsys.cam, 0.2)):
            np.testing.assert_allclose(np.stack(a), np.stack(b), rtol=1e-5, atol=1e-6)
    cam = same.cam
    hw = cam.width * cam.height
    rel = relative_pose(same.store.pose(1), same.store.pose(0))  # frame 1 from keyframe 0
    img1 = same.store.row("feat_pyr", 1)[:3, :hw]
    warped_t, valid_t = twarp.se3_warp_image(img1, same.store.depth_map(0), same.mapper.mask_flat,
                                             rel.rot, rel.trans, cam)
    warped_j, valid_j = jwarp.se3_warp_image(
        jnp.asarray(img1.numpy()), jsys.store.depth_map(0), jsys.mapper.mask_flat,
        jnp.asarray(rel.rot.numpy()), jnp.asarray(rel.trans.numpy()), jsys.cam)
    np.testing.assert_allclose(warped_t, warped_j, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(valid_t, valid_j)
    assert valid_t.mean() > 0.5
    np.testing.assert_array_equal(twarp.checkerboard(16, 20), jwarp.checkerboard(16, 20))
    frame_1 = SimpleNamespace(feat_pyr=same.store.row("feat_pyr", 1))
    for path in (tviz.render_map_png(same, str(tmp_path / "map.png")),
                 tviz.render_depth_png(same, 0, str(tmp_path / "d.png")),
                 twarp.render_warp_png(same, 0, frame_1, rel.rot, rel.trans, str(tmp_path / "w.png"))):
        assert os.path.getsize(path) > 0
