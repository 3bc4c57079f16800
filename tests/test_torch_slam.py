"""Port parity of the SLAM frontend: SlamSystem.bootstrap, process_frame,
the mapper step after each new keyframe and refine_mapping against the JAX
SlamSystem on tests/test_slam_e2e.py's tiny configuration (CPU).

Both systems see the same images (the JAX package's SyntheticInterface)
and the same network weights: the port's random init (a seeded
torch.Generator, fast) handed to the JAX system as its param tree. The
frames the JAX system builds reach the port's process_frame through
convert.frame_from_numpy (``frame=``), which keeps convolution roundoff out
of the comparison: with random networks, descriptor distances near a tie
would otherwise flip a nearest-neighbour match. JAX's keypoints are
injected (SlamSystem.keypoint_source), and the port's own frames draw
JAX's photometric ids (Mapper.location_source): the two PRNGs cannot
agree."""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sage_slam_tpu.models import depth_network as jdn
from sage_slam_tpu.models import feature_network as jfn
from sage_slam_tpu.tracker import matcher as jmatcher
from sage_slam_tpu_torch import config as tconfig
from sage_slam_tpu_torch import convert
from sage_slam_tpu_torch.frontend import slam as tslam
from sage_slam_tpu_torch.geometry import se3 as tse3
from sage_slam_tpu_torch.geometry.camera import PinholeCamera
from sage_slam_tpu_torch.loop import vocabulary as tvoc
from sage_slam_tpu_torch.models import depth_network as tdn
from sage_slam_tpu_torch.models import feature_network as tfn
from tests.test_slam_e2e import tiny_system

torch.set_num_threads(1)

N_FRAMES = 8


def _port_init(jax_module, port_module, seed):
    """An init_params for the JAX module that returns the port's seeded
    init as a JAX param tree (port parameter names are the tree's paths
    joined by dots)."""
    jax_init = jax_module.init_params

    def init_params(key, cfg):
        net = port_module.init_network(torch.Generator().manual_seed(seed),
                                       port_module_cfg(port_module, cfg))
        state = net.state_dict()
        shapes = jax.eval_shape(lambda: jax_init(key, cfg))

        def leaf(path, shape):
            name = ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
            assert tuple(state[name].shape) == shape.shape, name
            return jnp.asarray(state[name].numpy())

        return jax.tree_util.tree_map_with_path(leaf, shapes)

    return init_params


def port_module_cfg(port_module, cfg):
    cls = port_module.DepthNetConfig if port_module is tdn else port_module.FeatureNetConfig
    return cls(**cfg._asdict())


def jax_tiny_system():
    """tests/test_slam_e2e.py's tiny_system, its networks initialised by
    the port (JAX's eager init of them takes ~20 s on the CPU)."""
    with mock.patch.object(jdn, "init_params", _port_init(jdn, tdn, 2)), \
            mock.patch.object(jfn, "init_params", _port_init(jfn, tfn, 3)):
        return tiny_system(num_frames=N_FRAMES)


def port_system(jsys):
    """The port's SlamSystem with the JAX system's configuration, weights,
    camera and mask, on the CPU, drawing JAX's ids."""
    jm = jsys.mapper
    cfg = tconfig._from_dict(tconfig.SlamConfig, dataclasses.asdict(jsys.cfg))
    cam = jsys.cam
    tsys = tslam.SlamSystem(
        cfg, PinholeCamera(cam.fx, cam.fy, cam.cx, cam.cy, cam.width, cam.height),
        np.array(jm.mask),
        convert.depth_params_from_numpy(jax.tree.map(np.asarray, jm.depth_params),
                                        port_module_cfg(tdn, jm.depth_cfg), device="cpu"),
        convert.feature_params_from_numpy(jax.tree.map(np.asarray, jm.feat_params),
                                          port_module_cfg(tfn, jm.feat_cfg), device="cpu"),
        device="cpu",
    )
    valid, n = jm.valid_loc1d, jm.num_samples

    def jax_locations(timestamp):
        key = jax.random.key(int(timestamp * 1e6) & 0x7FFFFFFF)
        return np.asarray(jnp.take(valid, jax.random.permutation(key, valid.shape[0])[:n]))

    def jax_keypoints(kf_id):
        key = jax.random.key(tslam._match_seed(kf_id))
        return np.asarray(jmatcher.select_keypoints(key, valid, cfg.tracker.desc_num_keypoints))

    tsys.mapper.location_source = jax_locations
    tsys.keypoint_source = jax_keypoints
    return tsys


def record_frames(jsys):
    """Wrap the JAX mapper's build_frame: each frame is kept, as a copy
    taken before the JAX system rescales or re-poses it, under its
    timestamp."""
    built, build = {}, jsys.mapper.build_frame

    def build_frame(timestamp, image, pose=None):
        fr = build(timestamp, image, pose=pose)
        built[timestamp] = dataclasses.replace(fr)
        return fr

    jsys.mapper.build_frame = build_frame
    return built


@pytest.fixture(scope="module")
def run():
    """bootstrap, then process_frame on each later frame with a
    mapping_step after each new keyframe, then refine_mapping(2), in both
    packages; the per-frame results of each."""
    jsys, data = jax_tiny_system()
    tsys = port_system(jsys)
    built = record_frames(jsys)
    frames = list(data.frames())

    def frame(ts):
        return convert.frame_from_numpy(built[ts], device="cpu")

    assert jsys.bootstrap(frames[0].timestamp, jnp.asarray(frames[0].image)) == 0
    assert tsys.bootstrap(frames[0].timestamp, frame=frame(frames[0].timestamp)) == 0
    results = []
    for rec in frames[1:]:
        rj = jsys.process_frame(rec.timestamp, jnp.asarray(rec.image))
        rt = tsys.process_frame(rec.timestamp, frame=frame(rec.timestamp))
        step = None
        if rj.new_keyframe:
            step = (jsys.mapper.mapping_step(), jsys.mapper.last_step_iters)
        if rt.new_keyframe:
            step = (step, (tsys.mapper.mapping_step(), tsys.mapper.last_step_iters))
        results.append((rj, rt, step))
    refined = (jsys.refine_mapping(2), tsys.refine_mapping(2))
    return jsys, tsys, results, refined, built, frames


def _pose_close(tp, jp, atol):
    np.testing.assert_allclose(tp.rot.numpy(), np.asarray(jp.rot), atol=atol)
    np.testing.assert_allclose(tp.trans.numpy(), np.asarray(jp.trans), atol=atol)


def test_frame_decisions_follow_jax(run):
    """Per frame: the keyframe decision, the keyframe id and tracking_lost
    are equal, and a new keyframe's mapping_step takes the same number of
    iterations."""
    _, _, results, *_ = run
    for f, (rj, rt, step) in enumerate(results, start=1):
        assert (rt.new_keyframe, rt.keyframe_id, rt.tracking_lost) == (
            rj.new_keyframe, rj.keyframe_id, rj.tracking_lost), f"frame {f}"
        if rj.new_keyframe:
            (err_j, it_j), (err_t, it_t) = step
            assert it_t == it_j, f"frame {f}"
            np.testing.assert_allclose(err_t, err_j, rtol=1e-4, atol=1e-8, err_msg=f"frame {f}")
    assert sum(rj.new_keyframe for rj, _, _ in results) >= 1  # the run maps


def test_frame_poses_and_ratios_follow_jax(run):
    """Per frame: the tracked pose within 1e-4, the inlier and descriptor
    ratios within 1e-4 absolute, the area ratio within 1e-4 relative, the
    average motion (a fraction of the image diagonal) within 1e-4 relative
    + 1e-5 absolute (a mean of sqrt(du^2 + dv^2): near a zero motion the
    root turns float32 roundoff of the pose into ~1e-6), the tracker's
    error within 1e-3 relative + 1e-8 absolute."""
    _, _, results, *_ = run
    for f, (rj, rt, _) in enumerate(results, start=1):
        msg = f"frame {f}"
        _pose_close(rt.pose, rj.pose, 1e-4)
        np.testing.assert_allclose(rt.inlier_ratio, rj.inlier_ratio, atol=1e-4, err_msg=msg)
        np.testing.assert_allclose(rt.desc_inlier_ratio, rj.desc_inlier_ratio, atol=1e-4, err_msg=msg)
        np.testing.assert_allclose(rt.area_ratio, rj.area_ratio, rtol=1e-4, err_msg=msg)
        np.testing.assert_allclose(rt.average_motion, rj.average_motion, rtol=1e-4, atol=1e-5, err_msg=msg)
        np.testing.assert_allclose(rt.tracker_error, rj.tracker_error, rtol=1e-3, atol=1e-8, err_msg=msg)


def test_final_map_and_trajectories_follow_jax(run):
    """After refine_mapping(2): the store's variables and the keyframe and
    finalized trajectories agree (poses 1e-4, codes 1e-4, scales rtol
    1e-4); the store's links are equal."""
    jsys, tsys, _, refined, *_ = run
    n = tsys.store.num_active
    assert n == jsys.store.num_active >= 2
    assert tsys.refine_iterations == jsys.refine_iterations
    np.testing.assert_allclose(refined[1], refined[0], rtol=1e-4)
    jv, tv = jax.tree.map(np.asarray, jsys.store.variables), tsys.store.variables
    np.testing.assert_allclose(tv.pose.rot[:n].numpy(), jv.pose.rot[:n], atol=1e-4)
    np.testing.assert_allclose(tv.pose.trans[:n].numpy(), jv.pose.trans[:n], atol=1e-4)
    np.testing.assert_allclose(tv.code[:n].numpy(), jv.code[:n], atol=1e-4)
    np.testing.assert_allclose(tv.scale[:n].numpy(), jv.scale[:n], rtol=1e-4)
    assert tsys.store.links == jsys.store.links
    for (ts_t, p_t), (ts_j, p_j) in zip(tsys.keyframe_trajectory(), jsys.keyframe_trajectory()):
        assert ts_t == ts_j
        _pose_close(p_t, p_j, 1e-4)
    fin_t, fin_j = tsys.finalized_trajectory(), jsys.finalized_trajectory()
    assert len(fin_t) == len(fin_j) == N_FRAMES == len(tsys.trajectory)
    for (ts_t, p_t), (ts_j, p_j) in zip(fin_t, fin_j):
        assert ts_t == ts_j
        _pose_close(p_t, p_j, 1e-4)
    for i in range(n):
        assert torch.isfinite(tsys.store.depth_map(i)).all()


def test_kept_poses_and_scales_are_copies(run):
    """The store is written in place: a later in-place write of a keyframe
    row (pose and scale) moves the finalized poses of the frames tracked
    against it by that pose and by the scale change, and leaves the
    as-tracked trajectory alone (JAX: test_finalized_trajectory_follows_
    keyframe_updates)."""
    _, tsys, *_ = run
    twin = tsys.clone("cpu")
    kf = max(ref for _, ref, _, _ in twin.frame_refs if ref > 0)
    before = [(ts, tse3.SE3(p.rot.clone(), p.trans.clone())) for ts, p in twin.trajectory]
    fin0 = twin.finalized_trajectory()
    delta = tse3.se3_exp(torch.tensor([0.05, -0.02, 0.01, 0.1, -0.05, 0.2]))
    new_pose = tse3.compose(delta, twin.store.pose(kf))
    v = twin.store.variables
    v.pose.rot[kf], v.pose.trans[kf] = new_pose.rot, new_pose.trans
    v.scale[kf] *= 1.3
    fin1 = twin.finalized_trajectory()
    moved = 0
    for (_, ref, pose_ck, _), (_, a), (_, b) in zip(twin.frame_refs, fin1, fin0):
        if ref != kf:
            _pose_close(a, b, 1e-6)
            continue
        moved += 1
        kc = tse3.inverse(pose_ck)
        want = tse3.compose(new_pose, tse3.SE3(kc.rot, kc.trans * 1.3))
        np.testing.assert_allclose(a.trans.numpy(), want.trans.numpy(), atol=1e-5)
        np.testing.assert_allclose(a.rot.numpy(), want.rot.numpy(), atol=1e-5)
    assert moved > 0
    for (_, p0), (_, p1) in zip(before, twin.trajectory):
        assert torch.equal(p0.trans, p1.trans)
    # the clone shares nothing with the system it came from
    assert not torch.equal(tsys.store.variables.scale[kf], v.scale[kf])


def test_slam_system_contracts(run):
    """Without a vocabulary the global loop finds nothing and closing no
    loop changes nothing; a local-loop tick searches the newest keyframe;
    a vocabulary builds the BoW database; process_frame needs bootstrap;
    the default device is the card; the reference keyframe is the CLOSEST
    one, with ties to the first; LAST and FIRST pick as configured."""
    jsys, tsys, *_ = run
    twin = tsys.clone("cpu")
    n = twin.store.num_active
    assert twin.bow_db is None and twin.detect_global_loop(n - 1) == [] and twin.global_loop_tick() == []
    before = twin.store.variables.pose.trans.clone()
    assert twin.close_global_loops(n - 1, []) is None
    assert torch.equal(before, twin.store.variables.pose.trans)
    assert isinstance(twin.local_loop_tick(), tslam.LoopInfo)
    assert twin.store.local_loop_searched[:n].tolist() == [False] * (n - 1) + [True]
    args = (tsys.cfg, tsys.cam, np.ones((16, 20), np.float32), tsys.mapper.depth_net, tsys.mapper.feat_net)
    voc = tvoc.build_vocabulary(np.random.default_rng(0).standard_normal((200, 8)).astype(np.float32), k=3,
                                levels=2, device="cpu")
    with_voc = tslam.SlamSystem(*args, voc=voc, device="cpu")
    assert with_voc.bow_db.vectors.shape == (tsys.cfg.max_keyframes, voc.num_words)
    fresh = tslam.SlamSystem(*args, device="cpu")
    with pytest.raises(RuntimeError):
        fresh.process_frame(0.0, np.zeros((3, 32, 40), np.float32))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tslam.SlamSystem(*args)
    for i in range(n):
        assert tsys.select_keyframe(tsys.store.pose(i)) == i
    twin = tsys.clone("cpu")
    v = twin.store.variables
    v.pose.rot[1], v.pose.trans[1] = v.pose.rot[0], v.pose.trans[0]
    assert twin.select_keyframe(twin.store.pose(0)) == 0  # a tie goes to the first
    for mode, want in (("LAST", n - 1), ("FIRST", 0)):
        twin.cfg = dataclasses.replace(twin.cfg, tracking_mode=mode)
        assert twin.select_keyframe(twin.store.pose(1)) == want
    with np.errstate(over="ignore"):  # the JAX batch's uint32 form wraps
        wrapped = int((np.uint32(5) * np.uint32(2654435761) + np.uint32(1)) & np.uint32(0x7FFFFFFF))
    assert tslam._match_seed(5) == (5 * 2654435761 + 1) & 0x7FFFFFFF == wrapped


def test_port_frames_draw_the_jax_ids(run):
    """Mapper.location_source: the port's own frames sample JAX's
    photometric ids, and a frame the port builds from the same image
    agrees with JAX's within 2e-5 of each tensor's max |value| (network
    roundoff)."""
    _, tsys, _, _, built, frames = run
    for ts, jfr in built.items():
        np.testing.assert_array_equal(tsys.mapper.sample_locations(ts).numpy(), np.asarray(jfr.loc1d))
    rec = frames[3]
    tfr, jfr = tsys.mapper.build_frame(rec.timestamp, rec.image), built[rec.timestamp]
    np.testing.assert_array_equal(tfr.loc1d.numpy(), np.asarray(jfr.loc1d))
    for name in ("bias_flat", "feat_pyr", "feat_desc_flat", "src_feats", "packed_fg"):
        j = np.asarray(getattr(jfr, name))
        t = tfr.tables.packed_fg if name == "packed_fg" else getattr(tfr, name)
        np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=2e-5 * np.abs(j).max(),
                                   err_msg=name)
