"""Port parity of checkpoint / resume (mapping/serialize.py) and of the
partial state-dict loader (models/partial_unet.load_torch_state_dict).

The JAX system is tests/test_serialize.py's ``tiny_system`` (through
tests/test_torch_slam.py's ``jax_tiny_system``: its networks carry the
port's seeded init). It bootstraps on frame 0 and tracks frames 1-3, as
test_checkpoint_resume does, then writes a checkpoint. The port system
that runs the same frames gets JAX's frames (``process_frame(frame=)``)
with their derived tables rebuilt by the port (Mapper.frame_tables), and
JAX's sample ids and keypoints.

Held here:

* the port loads JAX's checkpoint to JAX's rows, variables, edges,
  trajectory and current keyframe exactly;
* its rebuilt derived tables (src_feats, packed / dense tables, bias_at,
  jac_at) equal, bit for bit, those of the port system that ran the
  frames;
* its next mapping_step matches JAX's UNINTERRUPTED system: equal LM
  iterations, error rtol 1e-4 (float32 roundoff through a 3-iteration
  solve); JAX's own resume, which leaves src_feats at zeros and the tables
  unset, is measured beside it (ROADMAP Queue 3);
* a checkpoint written by the port has JAX's keys and dtypes and loads in
  JAX to the same fields;
* load_torch_state_dict on a partial npz gives the networks JAX's loader
  gives, at tests/test_torch_models.py's tolerance (2e-5 of the output's
  max |value|), and keeps the seeded init of every missing key.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sage_slam_tpu.mapping import serialize as jser
from sage_slam_tpu.models import depth_network as jdn
from sage_slam_tpu.models import feature_network as jfn
from sage_slam_tpu.models import partial_unet as jpu
from sage_slam_tpu_torch import convert
from sage_slam_tpu_torch.mapping import serialize as tser
from sage_slam_tpu_torch.models import depth_network as tdn
from sage_slam_tpu_torch.models import feature_network as tfn
from sage_slam_tpu_torch.models import partial_unet as tpu
from tests.test_torch_slam import jax_tiny_system, port_system, record_frames

torch.set_num_threads(1)

ROWS = ("loc1d", "homo", "bias_flat", "jac_flat", "feat_pyr", "grad_pyr", "feat_desc", "avg_sq_bias")
TABLES = ("src_feats", "packed_fg", "packed_feat", "bias_at", "jac_at")


def _derived(store, name):
    """A derived table of the store: src_feats, or one of its FrameTables."""
    return store.src_feats if name == "src_feats" else getattr(store.tables, name)


def port_frame(tsys, jax_frame):
    """A JAX-built frame for the port, its derived tables rebuilt by the
    port's own Mapper.frame_tables."""
    fr = convert.frame_from_numpy(jax_frame, device="cpu")
    return dataclasses.replace(fr, **tsys.mapper.frame_tables(
        fr.feat_pyr, fr.grad_pyr, fr.loc1d, fr.bias_flat, fr.jac_flat))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ckpt")
    jsys, data = jax_tiny_system()
    tsys = port_system(jsys)
    built = record_frames(jsys)
    frames = list(data.frames())[:4]
    jsys.bootstrap(frames[0].timestamp, jnp.asarray(frames[0].image))
    tsys.bootstrap(frames[0].timestamp, frame=port_frame(tsys, built[frames[0].timestamp]))
    for rec in frames[1:]:
        jsys.process_frame(rec.timestamp, jnp.asarray(rec.image))
        tsys.process_frame(rec.timestamp, frame=port_frame(tsys, built[rec.timestamp]))
    jpath = str(tmp / "jax_state.npz")
    jser.save_state(jpath, jsys)

    # JAX's own resume into a fresh JAX system
    jres, _ = jax_tiny_system()
    jser.load_state(jpath, jres)
    # the port's resume into a fresh port system of the same configuration
    tres = port_system(jsys)
    tser.load_state(jpath, tres)
    return dict(jsys=jsys, tsys=tsys, jres=jres, tres=tres, jpath=jpath, tmp=tmp)


def test_port_loads_jax_checkpoint_to_jax_state(run):
    jsys, tres = run["jsys"], run["tres"]
    js, ts = jsys.store, tres.store
    n = ts.num_active
    assert n == js.num_active >= 2
    jv = jax.tree.map(np.asarray, js.variables)
    for t, j in ((ts.variables.pose.rot, jv.pose.rot), (ts.variables.pose.trans, jv.pose.trans),
                 (ts.variables.code, jv.code), (ts.variables.scale, jv.scale)):
        np.testing.assert_array_equal(t.numpy(), j)
    for name in ROWS:
        np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(getattr(js, name)), err_msg=name)
    assert ts.timestamps == js.timestamps and ts.links == js.links
    assert ts.global_loop_links == js.global_loop_links
    np.testing.assert_array_equal(ts.reinitialize_count, js.reinitialize_count)
    np.testing.assert_array_equal(ts.aux, js.aux)
    for name in ("photo_edges", "geo_edges", "photo_edge_iters", "geo_edge_iters"):
        assert getattr(tres.mapper, name) == [tuple(e) if isinstance(e, tuple) else e
                                              for e in getattr(jsys.mapper, name)], name
    assert tres.curr_kf == jsys.curr_kf and tres._visited == list(range(n))
    np.testing.assert_array_equal(tres.pose_ck.rot.numpy(), np.asarray(jsys.pose_ck.rot))
    assert len(tres.trajectory) == len(jsys.trajectory) == 4
    for (t0, p0), (t1, p1) in zip(tres.trajectory, jsys.trajectory):
        assert t0 == t1
        np.testing.assert_array_equal(p0.trans.numpy(), np.asarray(p1.trans))
        np.testing.assert_array_equal(p0.rot.numpy(), np.asarray(p1.rot))


def test_rebuilt_tables_equal_those_of_the_run(run):
    """Bit for bit against the port system that built the same frames: the
    derived tables, and the priors' anchor and scale target."""
    ts, tr = run["tsys"].store, run["tres"].store
    for name in TABLES:
        assert torch.equal(_derived(tr, name), _derived(ts, name)), name
    for name in ("dense_fg", "dense_feat"):
        a, b = getattr(tr.tables, name), getattr(ts.tables, name)
        assert len(a) == len(b) > 0 and all(torch.equal(x, y) for x, y in zip(a, b)), name
    n = tr.num_active
    assert float(tr.src_feats[:n].abs().max()) > 0.1
    np.testing.assert_array_equal(tr.version[:n], np.ones(n))
    # the priors init_one_frame set up (the first keyframe's pose anchor and
    # scale target) are rebuilt from the restored row
    for a, b in zip(run["tres"].mapper._prior_table(n), run["tsys"].mapper._prior_table(n)):
        for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
            assert torch.equal(x, y)


def test_resumed_mapping_step_matches_jax_uninterrupted(run):
    """The port's resumed step against JAX's uninterrupted one: equal LM
    iterations, error rtol 1e-4. JAX's resumed step (src_feats left at
    zeros, tables unset, no priors) is measured: it must be far from the
    uninterrupted error for this hold to mean anything."""
    jsys, jres, tres, tsys = run["jsys"], run["jres"], run["tres"], run["tsys"]
    src_before = float(np.abs(np.asarray(jsys.store.src_feats)).max())
    src_after = float(np.abs(np.asarray(jres.store.src_feats)).max())
    assert jres.store.packed_fg is None and jsys.store.packed_fg is not None
    err_j = jsys.mapper.mapping_step()
    it_j = jsys.mapper.last_step_iters
    err_jres = jres.mapper.mapping_step()
    err_t = tres.mapper.mapping_step()
    it_t = tres.mapper.last_step_iters
    err_run = tsys.mapper.mapping_step()
    print(f"JAX src_feats max |.| {src_before:.4f} before the save, {src_after:.4f} after JAX's load; "
          f"mapping_step error: JAX uninterrupted {err_j:.6f} ({it_j} iterations), JAX resumed "
          f"{err_jres:.6f}, port resumed {err_t:.6f} ({it_t}), port uninterrupted {err_run:.6f}")
    assert src_after == 0.0 < src_before
    assert it_t == it_j
    np.testing.assert_allclose(err_t, err_j, rtol=1e-4)
    np.testing.assert_allclose(err_t, err_run, rtol=1e-4)
    assert abs(err_jres - err_j) > 10 * abs(err_j)
    jv, tv = jax.tree.map(np.asarray, jsys.store.variables), tres.store.variables
    n = tres.store.num_active
    np.testing.assert_allclose(tv.pose.trans[:n].numpy(), jv.pose.trans[:n], atol=1e-4)
    np.testing.assert_allclose(tv.scale[:n].numpy(), jv.scale[:n], rtol=1e-4)


def test_port_checkpoint_loads_in_jax(run):
    """The port's file has JAX's keys and dtypes; JAX loads it to the
    port system's fields."""
    tsys = run["tsys"]
    path = str(run["tmp"] / "port_state.npz")
    tser.save_state(path, tsys)
    mine, theirs = np.load(path), np.load(run["jpath"])
    assert sorted(mine.files) == sorted(theirs.files)
    for key in theirs.files:
        assert mine[key].dtype == theirs[key].dtype, key
        assert mine[key].shape == theirs[key].shape, key
    jload, _ = jax_tiny_system()
    jser.load_state(path, jload)
    ts, js = tsys.store, jload.store
    n = ts.num_active
    assert js.num_active == n and jload.curr_kf == tsys.curr_kf
    jv = jax.tree.map(np.asarray, js.variables)
    np.testing.assert_array_equal(jv.pose.trans, ts.variables.pose.trans.numpy())
    np.testing.assert_array_equal(jv.scale, ts.variables.scale.numpy())
    for name in ROWS:
        np.testing.assert_array_equal(np.asarray(getattr(js, name)), getattr(ts, name).numpy(), err_msg=name)
    assert js.links == ts.links and js.timestamps == ts.timestamps
    assert jload.mapper.photo_edges == tsys.mapper.photo_edges
    assert jload.mapper.geo_edge_iters == tsys.mapper.geo_edge_iters
    for (t0, p0), (t1, p1) in zip(jload.trajectory, tsys.trajectory):
        assert t0 == t1
        np.testing.assert_array_equal(np.asarray(p0.trans), p1.trans.numpy())
    # and the port reads its own file back to the same state
    again = port_system(run["jsys"])
    tser.load_state(path, again)
    for name in ROWS:
        assert torch.equal(getattr(again.store, name), getattr(ts, name)), name
    for name in TABLES:
        assert torch.equal(_derived(again.store, name), _derived(ts, name)), name


NARROW_DEPTH = dict(filter_list=(4, 8, 16), bottleneck=16, bias_inner=(8, 1), basis_inner=((8, 4),))
NARROW_FEAT = dict(filter_list=(4, 8, 16), bottleneck=16, desc_inner=(8, 8), map_inner=(8, 8))


def _max_rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("which", ["depth", "feat"])
def test_load_torch_state_dict_partial_matches_jax(tmp_path, which):
    """A checkpoint holding every other parameter (perturbed), plus a key
    that names no parameter, loaded over the seeded init by both loaders."""
    tmod, jmod, kw = (tdn, jdn, NARROW_DEPTH) if which == "depth" else (tfn, jfn, NARROW_FEAT)
    tcfg = (tdn.DepthNetConfig if which == "depth" else tfn.FeatureNetConfig)(**kw)
    jcfg = (jdn.DepthNetConfig if which == "depth" else jfn.FeatureNetConfig)(**kw)
    init = tmod.init_network(torch.Generator().manual_seed(4), tcfg)
    state = {k: v.numpy().copy() for k, v in init.state_dict().items()}
    rng = np.random.default_rng(2)
    names = sorted(state)
    kept = {k: (state[k] + rng.normal(0, 0.05, state[k].shape)).astype(np.float64)
            for k in names[::2]}
    kept["not.a.parameter"] = np.zeros(3)
    path = str(tmp_path / "ckpt.npz")
    np.savez(path, **kept)
    sd = dict(np.load(path))

    net = tpu.load_torch_state_dict(tmod.init_network(torch.Generator().manual_seed(4), tcfg), sd)
    jparams = jax.tree.map(jnp.asarray, convert_tree(state, jax.eval_shape(
        lambda: jmod.init_params(jax.random.key(0), jcfg))))
    jloaded = jpu.load_torch_state_dict(jparams, sd)
    loaded = net.state_dict()
    for k in names:
        want = kept[k].astype(np.float32) if k in kept else state[k]
        np.testing.assert_array_equal(loaded[k].numpy(), want, err_msg=k)
        assert loaded[k].dtype == torch.float32

    img = np.random.default_rng(3).random((3, 32, 40)).astype(np.float32)
    mask = np.ones((1, 32, 40), np.float32)
    mask[:, :2] = 0.0
    with torch.no_grad():
        outs_t = tmod.apply(net, torch.from_numpy(img), torch.from_numpy(mask))
    outs_j = jmod.apply(jloaded, jnp.asarray(img), jnp.asarray(mask), jcfg)
    for a, b in zip(outs_t, outs_j):
        assert _max_rel(a.numpy(), np.asarray(b)) < 2e-5
    with pytest.raises(ValueError):
        tpu.load_torch_state_dict(net, {names[0]: np.zeros((1, 1))})


def convert_tree(flat, shapes):
    """{dotted name: array} -> the JAX param tree of ``shapes``."""
    def leaf(path, shape):
        name = ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        assert flat[name].shape == shape.shape, name
        return flat[name]

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def test_resume_keeps_store_tensors_and_clears_frame_refs(run, tmp_path):
    """load_state writes into the tensors allocated once (no rebinding) and
    restarts the finalized trajectory at the resume point."""
    tres = port_system(run["jsys"])
    st = tres.store
    ids = {name: id(getattr(st, name)) for name in ROWS + ("src_feats",)}
    ptrs = {name: getattr(st, name).data_ptr() for name in ROWS + ("src_feats",)}
    rot_ptr = st.variables.pose.rot.data_ptr()
    tser.load_state(run["jpath"], tres)
    for name in ids:
        assert id(getattr(st, name)) == ids[name] and getattr(st, name).data_ptr() == ptrs[name], name
    assert st.variables.pose.rot.data_ptr() == rot_ptr
    assert tres.frame_refs == [] and tres.finalized_trajectory() == []
