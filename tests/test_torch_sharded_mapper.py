"""Port parity of the mapper's sharded step, Mapper.mapping_step(mesh=),
and of refine_mapping's coarse-to-fine rounds, on tests/test_sharded_ba.py's
looped tiny system (test_slam_e2e's tiny_system with a 16-keyframe store:
bootstrap, 6 forced keyframes each followed by a mapping step, a loop
link with reprojection edges)
against the JAX package (CPU).

Both systems are built as tests/test_torch_slam.py builds them (the port's
seeded networks handed to JAX, JAX's frames and ids to the port). The port
runs on a one-rank gloo group in this process (parallel/launch.one_rank,
a file:// rendezvous under tmp_path); JAX on conftest's 4-device CPU mesh.
Each step starts from the same state: the port's from SlamSystem.clone,
JAX's restored from a snapshot of its mutable state."""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from sage_slam_tpu.models import depth_network as jdn
from sage_slam_tpu.models import feature_network as jfn
from sage_slam_tpu.tracker import matcher as jmatcher
from sage_slam_tpu_torch import convert
from sage_slam_tpu_torch.models import depth_network as tdn
from sage_slam_tpu_torch.models import feature_network as tfn
from sage_slam_tpu_torch.parallel import launch
from tests.test_slam_e2e import tiny_system
from tests.test_torch_slam import _port_init, port_system, record_frames

torch.set_num_threads(1)

N_FRAMES = 8
STEP_ITERS = 3


@pytest.fixture(scope="module")
def looped():
    with mock.patch.object(jdn, "init_params", _port_init(jdn, tdn, 2)), \
            mock.patch.object(jfn, "init_params", _port_init(jfn, tfn, 3)):
        jsys, data = tiny_system(num_frames=N_FRAMES, max_keyframes=16)
    tsys = port_system(jsys)
    built = record_frames(jsys)
    frames = list(data.frames())
    jsys.bootstrap(frames[0].timestamp, jnp.asarray(frames[0].image))
    tsys.bootstrap(frames[0].timestamp,
                   frame=convert.frame_from_numpy(built[frames[0].timestamp], device="cpu"))
    for rec in frames[1:7]:
        jsys.force_keyframe = tsys.force_keyframe = True
        jsys.process_frame(rec.timestamp, jnp.asarray(rec.image))
        tsys.process_frame(rec.timestamp,
                           frame=convert.frame_from_numpy(built[rec.timestamp], device="cpu"))
        # a mapping step after each keyframe, as the system runs; without
        # them the two packages pick different reference keyframes for
        # frame 4 (edge (4, 2) against JAX's (4, 3))
        jsys.mapper.mapping_step()
        tsys.mapper.mapping_step()
    n = jsys.store.num_active
    assert n == tsys.store.num_active >= 5
    # the link's reprojection edges draw JAX's keypoints from the same
    # per-edge seed (tests/test_torch_reprojection.py's reproj_pair)
    tm, k = tsys.mapper, tsys.cfg.mapper.desc_num_keypoints
    add_reproj = tm._add_reproj_edge

    def with_jax_keypoints(i0, i1, keypoints=None):
        key = jax.random.key((i0 * max(tm.store.num_active, 1) + i1) & 0x7FFFFFFF)
        kps = jmatcher.select_keypoints(key, jsys.mapper.valid_loc1d, k)
        return add_reproj(i0, i1, keypoints=np.asarray(kps))

    tm._add_reproj_edge = with_jax_keypoints
    jsys.mapper.enqueue_link(0, n - 1, True, True, True, True)
    tm.enqueue_link(0, n - 1, True, True, True, True)
    assert jsys.mapper.reproj_edges and tsys.mapper.reproj_edges
    return jsys, tsys, _jax_snapshot(jsys)


def _jax_snapshot(jsys):
    mp, st = jsys.mapper, jsys.store
    return (st.variables, st.version.copy(), st.reinitialize_count.copy(),
            list(mp.photo_edges), list(mp.photo_edge_iters), list(mp.geo_edges),
            list(mp.geo_edge_iters), [dict(ed) for ed in mp.reproj_edges])


def _jax_restore(jsys, snap):
    mp, st = jsys.mapper, jsys.store
    (st.variables, version, reinit, ph, ph_it, ge, ge_it, rp) = snap
    st.version, st.reinitialize_count = version.copy(), reinit.copy()
    mp.photo_edges, mp.photo_edge_iters = list(ph), list(ph_it)
    mp.geo_edges, mp.geo_edge_iters = list(ge), list(ge_it)
    mp.reproj_edges = [dict(ed) for ed in rp]


def _jax_mesh():
    return JMesh(np.array(jax.devices()[:4]), ("e",))


def _coarse(weights):
    """refine_mapping's coarse-round weights: the finer half zeroed."""
    return tuple(0.0 if lvl < len(weights) // 2 else weights[lvl] for lvl in range(len(weights)))


def _state_close(tsys, ref, n, atol, label, scale_rtol=None):
    """Poses, codes and scales of the first n keyframes: test_sharded_ba's
    atol 1e-5 between the sharded and single steps; ``ref`` a store's
    variables (JAX's or the port's)."""
    tv = tsys.store.variables
    rv = jax.tree.map(np.asarray, ref) if not isinstance(ref.scale, torch.Tensor) else ref
    for name, a, b in (("trans", tv.pose.trans, rv.pose.trans), ("rot", tv.pose.rot, rv.pose.rot),
                       ("code", tv.code, rv.code), ("scale", tv.scale, rv.scale)):
        b = b[:n].numpy() if isinstance(b, torch.Tensor) else np.asarray(b)[:n]
        if name == "scale" and scale_rtol is not None:
            np.testing.assert_allclose(a[:n].numpy(), b, rtol=scale_rtol, err_msg=f"{label} {name}")
        else:
            np.testing.assert_allclose(a[:n].numpy(), b, atol=atol, err_msg=f"{label} {name}")


def _bookkeeping(mp):
    return (list(mp.photo_edges), list(mp.photo_edge_iters), list(mp.geo_edges),
            list(mp.geo_edge_iters), [(ed["i0"], ed["i1"], ed.get("iters")) for ed in mp.reproj_edges])


def test_mapping_step_mesh_matches_jax_sharded_and_unsharded(looped, tmp_path):
    """test_mapping_step_sharded_matches_single_on_looped_map in the port:
    mapping_step(mesh=) against JAX's mapping_step_sharded on a 4-device
    mesh and against the port's own unsharded step from the same state
    (error rtol 1e-4; poses, codes, scales atol 1e-5); the same iterations
    and the same edge retirement bookkeeping as both."""
    jsys, tsys, snap = looped
    _jax_restore(jsys, snap)
    iters0 = list(jsys.mapper.photo_edge_iters)
    err_j = jsys.mapper.mapping_step_sharded(_jax_mesh(), max_iters=STEP_ITERS)
    it_j = jsys.mapper.last_step_iters
    j_after = (jsys.store.variables, _bookkeeping(jsys.mapper))
    _jax_restore(jsys, snap)
    sharded, single = tsys.clone("cpu"), tsys.clone("cpu")
    with launch.one_rank("cpu", workdir=str(tmp_path)) as mesh:
        assert mesh.size == 1 and mesh.rank == 0
        err_t = sharded.mapper.mapping_step_sharded(mesh, max_iters=STEP_ITERS)
    err_s = single.mapper.mapping_step(max_iters=STEP_ITERS)
    n = tsys.store.num_active
    assert sharded.mapper.last_step_iters == it_j == single.mapper.last_step_iters
    np.testing.assert_allclose(err_t, err_j, rtol=1e-4)
    np.testing.assert_allclose(err_t, err_s, rtol=1e-4)
    _state_close(sharded, j_after[0], n, 1e-5, "mesh vs JAX sharded")
    _state_close(sharded, single.store.variables, n, 1e-5, "mesh vs unsharded")
    # the same retirement bookkeeping as JAX's sharded step and the port's own
    assert _bookkeeping(sharded.mapper) == j_after[1] == _bookkeeping(single.mapper)
    assert sharded.mapper.photo_edge_iters != iters0
    assert sharded.mapper.last_step_edges == single.mapper.last_step_edges
    assert sharded.mapper.step_iters_total == single.mapper.step_iters_total


def test_mesh_step_takes_photo_weights(looped, tmp_path):
    """Coarse-to-fine weights on the mesh path: the port's sharded step
    with refine_mapping's coarse weights equals its unsharded step with
    them (the tolerances above), and differs from the full-weight step.
    The JAX package refuses this input (ROADMAP Queue 3: the assert at
    mapping/mapper.py:721 raises AssertionError)."""
    jsys, tsys, snap = looped
    coarse = _coarse(tsys.cfg.mapper.photo_factor_weights)
    sharded, single, full = tsys.clone("cpu"), tsys.clone("cpu"), tsys.clone("cpu")
    with launch.one_rank("cpu", workdir=str(tmp_path)) as mesh:
        err_t = sharded.mapper.mapping_step(max_iters=STEP_ITERS, full=True, mesh=mesh,
                                            photo_weights=coarse)
    err_s = single.mapper.mapping_step(max_iters=STEP_ITERS, full=True, photo_weights=coarse)
    err_f = full.mapper.mapping_step(max_iters=STEP_ITERS, full=True)
    assert sharded.mapper.last_step_iters == single.mapper.last_step_iters
    np.testing.assert_allclose(err_t, err_s, rtol=1e-4)
    _state_close(sharded, single.store.variables, tsys.store.num_active, 1e-5, "coarse")
    assert abs(err_t - err_f) > 1e-6 * abs(err_f)
    _jax_restore(jsys, snap)
    with pytest.raises(AssertionError):
        jsys.mapper.mapping_step(max_iters=STEP_ITERS, full=True, mesh=_jax_mesh(),
                                 photo_weights=coarse)
    _jax_restore(jsys, snap)


def test_refine_mapping_coarse_rounds_match_jax(looped):
    """refine_mapping(3) with refine_coarse_rounds=1 (the first round at the
    coarse weights) against JAX's from the same state: the same LM
    iterations; the error rtol 1e-4; poses and codes 1e-4, scales rtol
    1e-4 (test_torch_slam's final-map tolerances)."""
    jsys, tsys, snap = looped
    _jax_restore(jsys, snap)
    twin = tsys.clone("cpu")
    for system in (jsys, twin):
        cfg = dataclasses.replace(system.cfg, mapper=dataclasses.replace(
            system.cfg.mapper, refine_coarse_rounds=1))
        system.cfg = cfg
        system.mapper.cfg = cfg
    try:
        calls = []
        step = twin.mapper.mapping_step

        def recording(*args, **kwargs):
            calls.append(kwargs.get("photo_weights"))
            return step(*args, **kwargs)

        twin.mapper.mapping_step = recording
        err_t = twin.refine_mapping(3)
        err_j = jsys.refine_mapping(3)
        j_vars, j_iters = jsys.store.variables, jsys.refine_iterations
    finally:
        jcfg = dataclasses.replace(jsys.cfg, mapper=dataclasses.replace(
            jsys.cfg.mapper, refine_coarse_rounds=0))
        jsys.cfg = jsys.mapper.cfg = jcfg
        _jax_restore(jsys, snap)
    assert calls[0] == _coarse(twin.cfg.mapper.photo_factor_weights)
    assert all(w is None for w in calls[1:])
    assert twin.refine_iterations == j_iters
    np.testing.assert_allclose(err_t, err_j, rtol=1e-4)
    _state_close(twin, j_vars, twin.store.num_active, 1e-4, "refine", scale_rtol=1e-4)
