"""Port parity of loop closure in the SLAM system, and the threaded driver
(CPU).

tests/test_slam_loop.py's out-and-back sequence (12 frames, each made a
keyframe, the last one repeating frame 0's view) goes through the JAX
SlamSystem and the port's, built as tests/test_torch_slam.py builds them:
the port's seeded network init handed to the JAX system, JAX's frames
reaching the port through process_frame(frame=), JAX's ids through
Mapper.location_source and SlamSystem.keypoint_source. The vocabulary is
JAX's, trained on the first frame, carried by convert.vocabulary_from_numpy.

Both mappers take a constant depth of 1 (Mapper.depth_oracle: the
sequence is a fronto-parallel plane under pure translation), so the
metric re-fit of a verified loop sees consistent depths: with the tiny
random depth network every candidate fails the metric or cycle gate in
JAX too. The loop gates are test_slam_loop.py's relaxed ones. The 7-DoF
tracker runs at a budget of 10 LM iterations: near the optimum its accept
decisions are float32 ties that XLA's fused loop decides its own way
(ROADMAP Queue 3; at the default 400 the two packages verify different
candidates here), and 10 stops where the tracks still agree.
close_global_loops is given JAX's own LoopInfos, so the pose-graph solve is
held apart from the detection."""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sage_slam_tpu.loop import pose_graph as jpg
from sage_slam_tpu.loop import vocabulary as jvoc
from sage_slam_tpu.models import depth_network as jdn
from sage_slam_tpu.models import feature_network as jfn
from sage_slam_tpu_torch import config as tconfig
from sage_slam_tpu_torch import convert
from sage_slam_tpu_torch.frontend import slam as tslam
from sage_slam_tpu_torch.frontend.driver import SlamDriver
from sage_slam_tpu_torch.geometry import se3 as tse3
from sage_slam_tpu_torch.loop import vocabulary as tvoc
from sage_slam_tpu_torch.models import depth_network as tdn
from sage_slam_tpu_torch.models import feature_network as tfn
from sage_slam_tpu_torch.utils import timing
from tests.test_slam_e2e import tiny_system
from tests.test_slam_loop import OutAndBack, _relaxed_loop_cfg, _set_out_and_back_gt_poses, build_vocab_for
from tests.test_torch_slam import _port_init, port_system, record_frames

torch.set_num_threads(1)

N_FRAMES = 12
LOOP_ITERS = 10
LOCAL = dict(local_metric_ratio=0.3, local_dist_ratio=100.0, local_active_window=32)


def _systems():
    """(JAX system, port system, data, JAX vocabulary): test_slam_loop's
    tiny system with a 16-keyframe store and the port's init."""
    with mock.patch.object(jdn, "init_params", _port_init(jdn, tdn, 2)), \
            mock.patch.object(jfn, "init_params", _port_init(jfn, tfn, 3)):
        jsys, _ = tiny_system(num_frames=N_FRAMES, max_keyframes=16)
    data = OutAndBack(num_frames=N_FRAMES, height=32, width=40, seed=0, motion_scale=0.03)
    jv = build_vocab_for(jsys, data)
    jsys.voc, jsys.bow_db = jv, jvoc.BowDatabase(jv, jsys.cfg.max_keyframes)
    tsys = port_system(jsys)
    tsys.voc = convert.vocabulary_from_numpy(jax.tree.map(np.asarray, jv._asdict()), device="cpu")
    tsys.bow_db = tvoc.BowDatabase(tsys.voc, tsys.cfg.max_keyframes)
    jsys.mapper.depth_oracle = tsys.mapper.depth_oracle = _plane_depth
    return jsys, tsys, data, jv


def _plane_depth(timestamp):
    return np.ones((16, 20), np.float32)


def _port_cfg(jcfg):
    return tconfig._from_dict(tconfig.SlamConfig, dataclasses.asdict(jcfg))


def _relax(jsys, tsys, **local):
    jsys.cfg = _relaxed_loop_cfg(jsys.cfg, tracking_max_num_iters=LOOP_ITERS, **local)
    tsys.cfg = _port_cfg(jsys.cfg)


@pytest.fixture(scope="module")
def run():
    """Both systems through the out-and-back sequence; then, on both:
    global detection on the last keyframe, local detection on it with
    ground-truth-shaped poses (test_slam_loop.py's), close_global_loops with
    JAX's loops and one mapping_step after it."""
    jsys, tsys, data, _ = _systems()
    built = record_frames(jsys)
    frames = list(data.frames())
    jsys.bootstrap(frames[0].timestamp, jnp.asarray(frames[0].image))
    tsys.bootstrap(frames[0].timestamp, frame=convert.frame_from_numpy(built[frames[0].timestamp], device="cpu"))
    for rec in frames[1:]:
        jsys.force_keyframe = tsys.force_keyframe = True
        rj = jsys.process_frame(rec.timestamp, jnp.asarray(rec.image))
        rt = tsys.process_frame(rec.timestamp, frame=convert.frame_from_numpy(built[rec.timestamp], device="cpu"))
        assert rj.keyframe_id == rt.keyframe_id
    k = jsys.store.num_active
    out = dict(jsys=jsys, tsys=tsys, data=data, built=built, frames=frames, k=k)

    _relax(jsys, tsys)
    out["global"] = (jsys.detect_global_loop(k - 1), tsys.detect_global_loop(k - 1))

    # local detection on ground-truth-shaped poses, then JAX's back
    saved, twin = jsys.store.variables, tsys.clone("cpu")
    _relax(jsys, twin, **LOCAL)
    _set_out_and_back_gt_poses(jsys, data)
    v = twin.store.variables
    v.pose.trans[:k] = torch.from_numpy(np.array(jsys.store.variables.pose.trans[:k]))
    out["local"] = (jsys.detect_local_loop(k - 1), twin.detect_local_loop(k - 1))
    jsys.store.variables = saved
    _relax(jsys, tsys)

    jloops = out["global"][0]
    assert jloops, "JAX detected no global loop on the revisit"
    # the port closes from JAX's variables: the tracked states differ by
    # float32 roundoff, which the comparison below should not carry
    tclose = tsys.clone("cpu")
    out["pre_close"] = tsys.clone("cpu")
    jv0, tv0 = jax.tree.map(np.array, jsys.store.variables), tclose.store.variables
    for dst, src in ((tv0.pose.rot, jv0.pose.rot), (tv0.pose.trans, jv0.pose.trans), (tv0.code, jv0.code),
                     (tv0.scale, jv0.scale)):
        dst.copy_(torch.from_numpy(src))
    # JAX's edge linearization jitted (eager, its vmapped jacfwd re-traces
    # ~8 s per call on the CPU); the function is the same
    with mock.patch.object(jpg, "_edge_linearize", jax.jit(jpg._edge_linearize, static_argnums=(2, 3))):
        jsys.close_global_loops(k - 1, jloops)
    tclose.close_global_loops(k - 1, [convert.loop_info_from_numpy(lp, device="cpu") for lp in jloops])
    tv = tclose.store.variables
    out.update(
        tclose=tclose, loop_edges=list(tclose.mapper.photo_edges),
        closed=(jax.tree.map(np.asarray, jsys.store.variables), jsys.store.reinitialize_count.copy(),
                (tv.pose.rot.numpy().copy(), tv.pose.trans.numpy().copy(), tv.scale.numpy().copy()),
                tclose.store.reinitialize_count.copy()),
    )
    out["step"] = ((jsys.mapper.mapping_step(), jsys.mapper.last_step_iters),
                   (tclose.mapper.mapping_step(), tclose.mapper.last_step_iters))
    return out


def _pose_close(tp, jp, atol, msg=""):
    np.testing.assert_allclose(tp.rot.numpy(), np.asarray(jp.rot), atol=atol, err_msg=msg)
    np.testing.assert_allclose(tp.trans.numpy(), np.asarray(jp.trans), atol=atol, err_msg=msg)


def test_global_detection_follows_jax(run):
    """detect_global_loop(k-1): the same verified loops (id_ref), with
    pose_cur_ref within 1e-4, query_scale and ref_scale within 1e-4
    relative, the descriptor ratio within 1e-4, and the quality within
    2e-3: it is 1 - (cycle angle / 3 deg), the angle taken as arccos of a
    float32 trace near 1, which resolves angles to ~0.02 deg only."""
    jloops, tloops = run["global"]
    assert [lp.id_ref for lp in tloops] == [lp.id_ref for lp in jloops]
    assert jloops and all(lp.detected for lp in tloops)
    for jl, tl in zip(jloops, tloops):
        msg = f"loop to {jl.id_ref}"
        _pose_close(tl.pose_cur_ref, jl.pose_cur_ref, 1e-4, msg)
        for name in ("query_scale", "ref_scale"):
            np.testing.assert_allclose(getattr(tl, name), getattr(jl, name), rtol=1e-4, err_msg=msg)
        np.testing.assert_allclose(tl.quality, jl.quality, atol=2e-3, err_msg=msg)
        np.testing.assert_allclose(tl.desc_inlier_ratio, jl.desc_inlier_ratio, atol=1e-4, err_msg=msg)
    # every 7-DoF track ran at the loop's own budget
    assert run["tsys"].loop_track_iters and max(run["tsys"].loop_track_iters) <= LOOP_ITERS


def test_local_detection_follows_jax(run):
    """detect_local_loop(k-1) on test_slam_loop.py's ground-truth-shaped
    poses: detected, the same id_ref and descriptor ratio (1e-4), and a
    temporally far candidate."""
    jinfo, tinfo = run["local"]
    assert jinfo.detected and tinfo.detected
    assert tinfo.id_ref == jinfo.id_ref
    assert abs(tinfo.id_ref - (run["k"] - 1)) > run["tsys"].cfg.keyframe.temporal_max_back_connections
    np.testing.assert_allclose(tinfo.desc_inlier_ratio, jinfo.desc_inlier_ratio, atol=1e-4)


def test_close_global_loops_follows_jax(run):
    """close_global_loops with JAX's LoopInfos from JAX's state: store
    poses within 1e-5,
    scales within 1e-5 relative; reinitialize_count, global_loop_links,
    global_loops and the links equal; the pose-graph telemetry is set."""
    jsys, tsys, k = run["jsys"], run["tclose"], run["k"]
    jv, j_reinit, (rot, trans, scale), t_reinit = run["closed"]
    np.testing.assert_allclose(rot[:k], jv.pose.rot[:k], atol=1e-5)
    np.testing.assert_allclose(trans[:k], jv.pose.trans[:k], atol=1e-5)
    np.testing.assert_allclose(scale[:k], jv.scale[:k], rtol=1e-5)
    np.testing.assert_array_equal(t_reinit, j_reinit)
    assert t_reinit[k - 1] > 0
    assert tsys.store.global_loop_links == jsys.store.global_loop_links
    assert tsys.store.links == jsys.store.links
    assert tsys.global_loops.keys() == jsys.global_loops.keys()
    for key, (s0, s1) in jsys.global_loops.items():
        np.testing.assert_allclose(tsys.global_loops[key], (s0, s1), rtol=1e-6)
    assert tsys.last_pose_graph["iterations"] >= 1 and tsys.last_pose_graph["edges"] > 0
    for i in range(k):
        assert torch.isfinite(tsys.store.depth_map(i)).all()


def test_mapping_step_after_the_loop_follows_jax(run):
    """The mapping_step after the write-back: JAX's iterations, its error
    within 1e-4 relative, the reinitialized rows frozen (unchanged) and
    released after it; the loop links' photometric edges are in the
    mapper's lists, as in JAX."""
    jsys, tsys, k = run["jsys"], run["tclose"], run["k"]
    (err_j, it_j), (err_t, it_t) = run["step"]
    assert it_t == it_j
    np.testing.assert_allclose(err_t, err_j, rtol=1e-4)
    _, _, (rot, trans, scale), t_reinit = run["closed"]
    frozen = np.flatnonzero(t_reinit > 0)
    v = tsys.store.variables
    np.testing.assert_array_equal(v.pose.trans[frozen].numpy(), trans[frozen])
    np.testing.assert_array_equal(v.scale[frozen].numpy(), scale[frozen])
    assert tsys.store.reinitialize_count.sum() == jsys.store.reinitialize_count.sum() == 0
    assert run["pre_close"].store.reinitialize_count.sum() == 0  # a clone shares nothing
    for a, b in tsys.global_loops:
        assert (a, b) in run["loop_edges"] and (b, a) in run["loop_edges"]
        # the step's own problem held the loop link's photometric edges
        assert (a, b) in tsys.mapper.last_step_photo_pairs and (b, a) in tsys.mapper.last_step_photo_pairs
    assert len(tsys.mapper.last_step_photo_pairs) == tsys.mapper.last_step_edges[0]
    assert tsys.mapper.photo_edges == jsys.mapper.photo_edges
    np.testing.assert_allclose(v.pose.trans[:k].numpy(), np.asarray(jsys.store.variables.pose.trans[:k]),
                               atol=1e-4)


def test_tick_scheduling_newest_first_every_keyframe_once(run):
    """local_loop_tick walks the searched flags newest first, each keyframe
    once, then returns None; global_loop_tick searches every keyframe."""
    sys_ = run["pre_close"].clone("cpu")
    sys_.cfg = dataclasses.replace(sys_.cfg, loop=tconfig.LoopConfig(tracking_max_num_iters=LOOP_ITERS))
    k = sys_.store.num_active
    order = []
    for _ in range(k + 2):
        before = sys_.store.local_loop_searched.copy()
        sys_.local_loop_tick()
        newly = np.flatnonzero(sys_.store.local_loop_searched & ~before)
        if len(newly):
            order.append(int(newly[0]))
    assert order == list(range(k - 1, -1, -1))
    assert sys_.local_loop_tick() is None
    for _ in range(k + 2):
        sys_.global_loop_tick()
    assert sys_.store.global_loop_searched[:k].all()
    assert not sys_.store.global_loop_searched[k:].any()
    # the flags travel with a clone
    assert sys_.clone("cpu").store.local_loop_searched[:k].all()


def test_loop_telemetry_records_gates_and_spans(run):
    """detect_global_loop with the descriptor gate above any ratio: every
    candidate is recorded in loop_rejections as (query, reference,
    "desc_ratio", value, limit); the scan's end at the database's empty rows
    is not a rejection; the call is one utils/timing span (host clock, no
    CUDA events on the CPU), and nothing is recorded with timing off."""
    sys_, k = run["pre_close"].clone("cpu"), run["k"]
    sys_.cfg = dataclasses.replace(sys_.cfg, loop=dataclasses.replace(sys_.cfg.loop, min_desc_inlier_ratio=1.5))
    assert sys_.bow_db.count < sys_.bow_db.capacity  # empty rows end the scan
    sys_.loop_rejections = []
    timing.reset()
    timing.enable(True)
    try:
        assert sys_.detect_global_loop(k - 1) == []
    finally:
        timing.enable(False)
    rejected = sys_.loop_rejections
    assert rejected and {r[2] for r in rejected} == {"desc_ratio"}
    for query, ref, _, value, limit in rejected:
        assert query == k - 1 and ref != k - 1 and 0.0 <= value < limit == 1.5
    [(host_ms, event_ms)] = timing.calls("detect_global_loop")
    assert host_ms > 0 and np.isnan(event_ms)
    assert timing.calls("track_7dof") == []  # the gate stops before any track
    timing.reset()
    sys_.detect_global_loop(k - 1)
    assert timing.calls("detect_global_loop") == [] and timing.report() == ""


def test_keyframe_landing_during_the_solve_is_propagated(run):
    """A keyframe created through _loop_solve_hook while the pose-scale
    graph solves is moved rigidly with the last in-graph keyframe, its
    translation and scale scaled by that keyframe's scale change, and is
    reinitialized (tests/test_concurrency.py:122-203's identity)."""
    sys_, k = run["pre_close"].clone("cpu"), run["k"]
    loops = run["global"][1]
    extra = run["built"][run["frames"][1].timestamp]
    captured = {}

    def hook():
        sys_.force_keyframe = True
        fr = convert.frame_from_numpy(dataclasses.replace(extra, timestamp=extra.timestamp + 100.0), device="cpu")
        res = sys_.process_frame(extra.timestamp + 100.0, frame=fr)
        assert res.new_keyframe
        nid = res.keyframe_id
        captured.update(id=nid, pose=tslam._copy_pose(sys_.store.pose(nid)),
                        scale=float(sys_.store.variables.scale[nid]),
                        last=tslam._copy_pose(sys_.store.pose(k - 1)),
                        last_scale=float(sys_.store.variables.scale[k - 1]))

    sys_._loop_solve_hook = hook
    sys_.close_global_loops(k - 1, loops)
    nid = captured["id"]
    assert nid == k and sys_.store.reinitialize_count[nid] > 0
    ratio = float(sys_.store.variables.scale[k - 1]) / captured["last_scale"]
    before = tse3.relative_pose(captured["last"], captured["pose"])
    after = tse3.relative_pose(sys_.store.pose(k - 1), sys_.store.pose(nid))
    np.testing.assert_allclose(after.rot.numpy(), before.rot.numpy(), atol=1e-5)
    np.testing.assert_allclose(after.trans.numpy(), before.trans.numpy() * ratio, atol=1e-5)
    np.testing.assert_allclose(float(sys_.store.variables.scale[nid]), captured["scale"] * ratio, rtol=1e-5)


def _driver_system(run):
    """A fresh port system with the run's configuration, weights and
    vocabulary (its own frames, JAX's sampling ids), LoopConfig's gates."""
    tsys = port_system(run["jsys"])
    tsys.mapper.depth_oracle = _plane_depth
    tsys.cfg = dataclasses.replace(_port_cfg(run["jsys"].cfg),
                                   loop=tconfig.LoopConfig(tracking_max_num_iters=LOOP_ITERS))
    tsys.voc = run["tsys"].voc
    tsys.bow_db = tvoc.BowDatabase(tsys.voc, tsys.cfg.max_keyframes)
    return tsys


class _Forced:
    """The run's frames, every 2nd made a keyframe."""

    def __init__(self, system, frames):
        self.system, self.records = system, frames

    def frames(self):
        for f, rec in enumerate(self.records):
            self.system.force_keyframe = self.system.force_keyframe or f % 2 == 0
            yield rec


def test_threaded_driver_runs_and_drains(run):
    """SlamDriver with native threads on the CPU: every frame is tracked,
    every keyframe searched by both loop backends, every pose, scale and
    depth map finite; each thread paid its solver set-up once, apart from
    its ticks."""
    tsys = _driver_system(run)
    driver = SlamDriver(tsys, use_native_threads=True)
    timing.reset()
    timing.enable(True)
    try:
        results = driver.run(_Forced(tsys, run["frames"]), max_frames=8)
    finally:
        timing.enable(False)
    for thread in ("frame loop", "mapping worker", "loop worker"):
        assert len(timing.calls(f"solver set-up ({thread})")) == 1
    assert timing.calls("mapping_tick") and timing.calls("loop_tick")
    n = tsys.store.num_active
    assert len(results) == 7 and len(tsys.trajectory) == 8 and n >= 4
    assert tsys.store.local_loop_searched[:n].all() and tsys.store.global_loop_searched[:n].all()
    v = tsys.store.variables
    assert all(torch.isfinite(t).all() for t in (v.pose.rot, v.pose.trans, v.scale))
    assert all(torch.isfinite(tsys.store.depth_map(i)).all() for i in range(n))
    assert driver.runtime is None


def test_driver_without_threads_drains_and_refines(run):
    """use_native_threads=False: a mapping_step after each keyframe on the
    calling thread, then the drain searches every keyframe once and
    refine_mapping runs."""
    tsys = _driver_system(run)
    steps = []
    step = tsys.mapper.mapping_step

    def counted(*args, **kwargs):
        steps.append(kwargs.get("full", False))
        return step(*args, **kwargs)

    tsys.mapper.mapping_step = counted
    SlamDriver(tsys, use_native_threads=False).run(_Forced(tsys, run["frames"]), max_frames=8)
    n = tsys.store.num_active
    assert tsys.store.local_loop_searched[:n].all() and tsys.store.global_loop_searched[:n].all()
    assert steps.count(False) == n - 1 and steps.count(True) >= 1  # refine_mapping's full steps


def test_worker_exception_makes_run_raise(run):
    """A mapping worker that raises: run() raises on the calling thread
    with the worker's exception as its cause; the workers are stopped."""
    tsys = _driver_system(run)

    def broken(*args, **kwargs):
        raise ValueError("mapping worker failed")

    tsys.mapper.mapping_step = broken
    driver = SlamDriver(tsys, use_native_threads=True)
    with pytest.raises(RuntimeError, match="'mapping' failed") as info:
        driver.run(_Forced(tsys, run["frames"]))
    assert isinstance(info.value.__cause__, ValueError)
    assert driver.runtime is None
