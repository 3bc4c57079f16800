"""Port parity of the mapper slice: build_frame, the keyframe store and the
windowed mapping_step against the JAX Mapper on the same inputs (CPU).

The networks are narrow and randomly initialised; the JAX params reach
the port through the weight carry, and frames the JAX mapper built reach
the port's mapper through convert.frame_from_numpy, which keeps conv
roundoff out of the BA comparison. Photometric samples are injected (the
two PRNGs cannot agree)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sage_slam_tpu import config as jconfig
from sage_slam_tpu.geometry.camera import CameraPyramid as JPyr
from sage_slam_tpu.geometry.camera import PinholeCamera as JCam
from sage_slam_tpu.geometry.se3 import SE3 as JSE3
from sage_slam_tpu.mapping.mapper import Mapper as JMapper
from sage_slam_tpu.models import depth_network as jdn
from sage_slam_tpu.models import feature_network as jfn
from sage_slam_tpu_torch import config as tconfig
from sage_slam_tpu_torch import convert, synthetic
from sage_slam_tpu_torch.geometry import se3 as tse3
from sage_slam_tpu_torch.geometry.camera import CameraPyramid
from sage_slam_tpu_torch.mapping import mapper as tmapper
from sage_slam_tpu_torch.mapping.keyframe_store import KeyframeStore
from sage_slam_tpu_torch.models import depth_network as tdn
from sage_slam_tpu_torch.models import feature_network as tfn

torch.set_num_threads(1)

CS, FS = 4, 8
DEPTH = dict(filter_list=(4, 8, 16), bottleneck=16, bias_inner=(8, 1), basis_inner=((8, CS),))
FEAT = dict(filter_list=(4, 8, 16), bottleneck=16, desc_inner=(8, FS), map_inner=(8, FS))
N_KF = 5


def _slam_cfg(mod, **mapper_kw):
    mapper = dict(pho_num_samples=64, desc_num_keypoints=32, window_size=4, max_gn_iters=3)
    mapper.update(mapper_kw)
    return mod.SlamConfig(
        net_input_size=(32, 40), net_output_size=(16, 20), code_size=CS, feat_size=FS,
        pyramid_levels=3, max_keyframes=8,
        tracker=mod.TrackerConfig(desc_num_keypoints=32),
        mapper=mod.MapperConfig(**mapper),
    )


class Pair:
    """A JAX Mapper and the port's Mapper on the same scene and weights.
    JAX frames are built once per process (the JAX build_frame jit is per
    mapper instance) and handed to both mappers as copies."""

    _frames = {}

    def __init__(self, **mapper_kw):
        self.scene = synthetic.mapper_scene(N_KF + 2, seed=3, height=32, width=40)
        cam = self.scene.camera
        jcam = JCam(cam.fx, cam.fy, cam.cx, cam.cy, cam.width, cam.height)
        self.dcfg, self.fcfg = jdn.DepthNetConfig(**DEPTH), jfn.FeatureNetConfig(**FEAT)
        dparams = jdn.init_params(jax.random.key(1), self.dcfg)
        fparams = jfn.init_params(jax.random.key(2), self.fcfg)
        self.jm = JMapper(
            _slam_cfg(jconfig, **mapper_kw), JPyr.build(jcam, 3), jnp.asarray(self.scene.mask_out),
            dparams, fparams, self.dcfg, self.fcfg, video_mask_in=jnp.asarray(self.scene.mask_in),
        )
        self._jax_build_frame = self.jm.build_frame
        self.jm.build_frame = self.jax_frame_at  # init_one_frame builds through it
        self.tm = tmapper.Mapper(
            _slam_cfg(tconfig, **mapper_kw), CameraPyramid.build(cam, 3), self.scene.mask_out,
            convert.depth_params_from_numpy(jax.tree.map(np.asarray, dparams),
                                            tdn.DepthNetConfig(**DEPTH), device="cpu"),
            convert.feature_params_from_numpy(jax.tree.map(np.asarray, fparams),
                                              tfn.FeatureNetConfig(**FEAT), device="cpu"),
            video_mask_in=self.scene.mask_in, device="cpu",
        )

    def jax_frame_at(self, timestamp, image, pose=None):
        """The JAX mapper's build_frame, cached by (timestamp, pose); a copy,
        since the mappers rescale the frames they enqueue."""
        key = (timestamp, None if pose is None else np.asarray(pose.trans).tobytes())
        if key not in Pair._frames:
            Pair._frames[key] = self._jax_build_frame(timestamp, image, pose=pose)
        return dataclasses.replace(Pair._frames[key])

    def jax_frame(self, f, pose=True):
        p = JSE3(jnp.asarray(self.scene.rot[f]), jnp.asarray(self.scene.trans[f])) if pose else None
        return self.jax_frame_at(0.1 * f, jnp.asarray(self.scene.images[f]), pose=p)

    def init(self):
        fr = self.jax_frame(0, pose=False)
        self.jm.init_one_frame(0.0, jnp.asarray(self.scene.images[0]))
        self.tm.init_one_frame(0.0, frame=convert.frame_from_numpy(fr, device="cpu"))

    def add_keyframe(self, f):
        fr = self.jax_frame(f)
        tfr = convert.frame_from_numpy(fr, device="cpu")
        n = self.jm.store.num_active
        back = list(range(n - 1, max(-1, n - 4), -1))
        self.jm.enqueue_keyframe(fr, back)
        self.tm.enqueue_keyframe(tfr, back)


def _assert_vars_close(tv, jv, n, pose_atol=2e-6, code_atol=1e-6):
    np.testing.assert_allclose(tv.pose.trans[:n].numpy(), np.asarray(jv.pose.trans[:n]), atol=pose_atol)
    np.testing.assert_allclose(tv.pose.rot[:n].numpy(), np.asarray(jv.pose.rot[:n]), atol=pose_atol)
    np.testing.assert_allclose(tv.code[:n].numpy(), np.asarray(jv.code[:n]), atol=code_atol)
    np.testing.assert_allclose(tv.scale[:n].numpy(), np.asarray(jv.scale[:n]), rtol=1e-6)


@pytest.fixture(scope="module")
def sequence():
    """init + N_KF-1 keyframes (back connections to the previous 3), one
    mapping_step after each; per step: JAX and port telemetry, errors."""
    pair = Pair()
    pair.init()
    steps = []
    for f in range(1, N_KF):
        pair.add_keyframe(f)
        err_j = pair.jm.mapping_step()
        err_t = pair.tm.mapping_step()
        steps.append(dict(
            jax=(pair.jm.last_step_iters, pair.jm.last_step_converged, err_j),
            port=(pair.tm.last_step_iters, pair.tm.last_step_converged, err_t),
            edges=pair.tm.last_step_edges,
            jvars=jax.tree.map(np.asarray, pair.jm.store.variables),
            tvars=pair.tm.store.snapshot()[2],
        ))
    return pair, steps


def test_build_frame_matches_jax():
    """Same image, the JAX loc1d injected: every frame tensor agrees within
    2e-5 of its max |value| (network roundoff; tables are gathers of it)."""
    pair = Pair()
    fr = pair.jax_frame(1)
    tfr = pair.tm.build_frame(0.1, pair.scene.images[1], loc1d=np.asarray(fr.loc1d))
    np.testing.assert_array_equal(tfr.loc1d.numpy(), np.asarray(fr.loc1d))
    np.testing.assert_allclose(tfr.homo.numpy(), np.asarray(fr.homo), rtol=1e-6, atol=1e-7)
    tab = tfr.tables  # a frame's tables lead with a keyframe axis of 1, JAX's decode tables none
    tables = {"packed_fg": tab.packed_fg, "packed_feat": tab.packed_feat, "bias_at": tab.bias_at[0],
              "jac_at": tab.jac_at[0]}
    for name in ("bias_flat", "jac_flat", "feat_pyr", "grad_pyr", "src_feats", "packed_fg",
                 "packed_feat", "bias_at", "jac_at", "avg_sq_bias"):
        t = (tables[name] if name in tables else getattr(tfr, name)).numpy()
        j = np.asarray(getattr(fr, name))
        assert t.shape == j.shape, name
        np.testing.assert_allclose(t, j, rtol=0, atol=2e-5 * max(np.abs(j).max(), 1e-6), err_msg=name)
    np.testing.assert_allclose(tfr.feat_desc_flat.numpy(), np.asarray(fr.feat_desc_flat), atol=2e-5)
    for t, j in zip(tab.dense_fg + tab.dense_feat, fr.dense_fg + fr.dense_feat):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=2e-5 * np.abs(np.asarray(j)).max())
    assert len(tab.dense_fg) == len(fr.dense_fg) and tfr.scale == fr.scale == 1.0
    # the default draw is seeded from the timestamp and lies in the mask
    drawn = pair.tm.build_frame(0.1, pair.scene.images[1])
    again = pair.tm.sample_locations(0.1)
    np.testing.assert_array_equal(drawn.loc1d.numpy(), again.numpy())
    assert len(set(again.tolist())) == pair.tm.num_samples
    assert pair.scene.mask_out.reshape(-1)[again.numpy()].min() == 1.0


def test_mapping_sequence_follows_jax(sequence):
    """Every step: equal iteration counts and converged flags; errors and
    variables within float32 roundoff."""
    pair, steps = sequence
    for s, step in enumerate(steps):
        it_j, conv_j, err_j = step["jax"]
        it_t, conv_t, err_t = step["port"]
        assert (it_t, conv_t) == (it_j, conv_j), f"step {s}"
        np.testing.assert_allclose(err_t, err_j, rtol=1e-4, err_msg=f"step {s}")
        _assert_vars_close(step["tvars"], step["jvars"], s + 2)
    assert pair.tm.store.num_active == N_KF
    assert pair.tm.photo_edges == pair.jm.photo_edges
    assert pair.tm.geo_edges == pair.jm.geo_edges
    assert pair.tm.photo_edge_iters == pair.jm.photo_edge_iters


def test_mapping_steps_see_live_edges_and_descend(sequence):
    """Edge tables at the live count (the JAX buckets pad to 128): each
    keyframe adds two edges per back-connection, all incident to the
    window here; the store stays finite."""
    pair, steps = sequence
    assert [s["edges"][0] for s in steps] == [2, 6, 12, 18]
    assert [s["edges"][1] for s in steps] == [2, 6, 12, 18]
    assert all(s["edges"][2] == 0 for s in steps)
    for v in (pair.tm.store.variables.pose.rot, pair.tm.store.variables.code):
        assert torch.isfinite(v).all()
    assert all(s["port"][0] > 0 for s in steps)


def test_store_rows_match_jax_store(sequence):
    pair, _ = sequence
    n = pair.tm.store.num_active
    js, ts = pair.jm.store, pair.tm.store
    for name in ("loc1d", "bias_flat", "src_feats", "avg_sq_bias"):
        np.testing.assert_array_equal(getattr(ts, name)[:n].numpy(), np.asarray(getattr(js, name))[:n])
    np.testing.assert_array_equal(ts.tables.bias_at[:n].numpy(), np.asarray(js.bias_at)[:n])
    np.testing.assert_array_equal(ts.feat_pyr[:, :n].numpy(), np.asarray(js.feat_pyr)[:, :n])
    np.testing.assert_array_equal(ts.tables.packed_fg.numpy(), np.asarray(js.packed_fg))
    for t, j in zip(ts.tables.dense_feat, js.dense_feat):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert ts.links == js.links
    np.testing.assert_array_equal(ts.version, js.version)
    for i in range(n):
        # decoded depth: the variables' float32 roundoff times bias + jac.code
        np.testing.assert_allclose(ts.depth_map(i).numpy(), np.asarray(js.depth_map(i)),
                                   rtol=1e-5, atol=1e-5)
        assert ts.row("grad_pyr", i).shape == js.row("grad_pyr", i).shape
    assert ts.nbytes() > 0


def test_medians_of_an_even_count():
    """jnp.median averages the two middle values; torch.median returns the
    lower. init_one_frame divides by the JAX median."""
    x = np.random.default_rng(0).standard_normal(5120).astype(np.float32)
    m = tmapper.median(torch.from_numpy(x))
    assert float(m) == float(jnp.median(jnp.asarray(x)))
    assert float(torch.median(torch.from_numpy(x))) != float(m)
    assert float(tmapper.median(torch.from_numpy(x[:-1]))) == float(jnp.median(jnp.asarray(x[:-1])))
    pair = Pair()
    fr = pair.jax_frame(0, pose=False)
    tfr = convert.frame_from_numpy(fr, device="cpu")
    pair.jm.init_one_frame(0.0, jnp.asarray(pair.scene.images[0]))
    pair.tm.init_one_frame(0.0, frame=tfr)
    js, ts = pair.jm.store.variables.scale[0], pair.tm.store.variables.scale[0]
    np.testing.assert_allclose(float(ts), float(js), rtol=2e-6)
    # correct_depth_scale's host median (np.median over the finite ratios)
    fr1 = convert.frame_from_numpy(pair.jax_frame(1), device="cpu")
    s_t = pair.tm.correct_depth_scale(fr1, 0)
    s_j = pair.jm.correct_depth_scale(pair.jax_frame(1), 0)
    np.testing.assert_allclose(s_t, s_j, rtol=1e-5)


def _grown(n_kf=4, **mapper_kw):
    pair = Pair(**mapper_kw)
    pair.init()
    for f in range(1, n_kf):
        pair.add_keyframe(f)
    return pair


def test_edge_retirement_follows_jax():
    """A budget of 2 iterations: one 3-iteration step retires every
    linearized edge in both mappers; a later step with no edges runs."""
    pair = _grown(3, factor_iters=2)
    before = len(pair.tm.photo_edges)
    pair.jm.mapping_step(max_iters=3)
    pair.tm.mapping_step(max_iters=3)
    assert pair.tm.last_step_iters == pair.jm.last_step_iters
    assert len(pair.tm.photo_edges) < before
    assert pair.tm.photo_edges == pair.jm.photo_edges
    assert pair.tm.geo_edges == pair.jm.geo_edges
    assert len(pair.tm.geo_edge_iters) == len(pair.tm.geo_edges)
    pair.tm.mapping_step(max_iters=1)
    assert pair.tm.last_step_edges[0] == len(pair.tm.photo_edges)


def test_aux_frame_is_pose_only():
    """enqueue_frame adds a pose-only variable with a one-way photometric
    edge: the step moves its pose, not its code or scale, and matches JAX."""
    pair = _grown(3)
    ref = pair.tm.store.num_active - 1
    guess = tse3.retract(pair.tm.store.pose(ref), torch.tensor([0.01, -0.005, 0.0, 0.0, 0.0, 0.01]))
    jfr = pair.jax_frame_at(0.35, jnp.asarray(pair.scene.images[3]),
                            pose=JSE3(jnp.asarray(guess.rot.numpy()), jnp.asarray(guess.trans.numpy())))
    tfr = convert.frame_from_numpy(jfr, device="cpu")
    fid = pair.tm.enqueue_frame(tfr, ref)
    assert pair.jm.enqueue_frame(jfr, ref) == fid
    assert pair.tm.store.aux[fid] and (ref, fid) in pair.tm.photo_edges
    assert (fid, ref) not in pair.tm.photo_edges
    code0 = pair.tm.store.variables.code[fid].clone()
    scale0 = float(pair.tm.store.variables.scale[fid])
    trans0 = pair.tm.store.variables.pose.trans[fid].clone()
    pair.jm.mapping_step(max_iters=3)
    pair.tm.mapping_step(max_iters=3)
    v = pair.tm.store.variables
    assert torch.equal(v.code[fid], code0) and float(v.scale[fid]) == scale0
    assert float((v.pose.trans[fid] - trans0).abs().max()) > 0
    assert pair.tm.last_step_iters == pair.jm.last_step_iters
    _assert_vars_close(v, jax.tree.map(np.asarray, pair.jm.store.variables), fid + 1)


def test_merge_keeps_rows_written_during_the_solve():
    """A row rewritten under the lock during the solve (version bumped: a
    loop closure) and a keyframe added during it keep the store's values
    after the merge; the solve itself never saw either write."""
    pair = _grown(3)
    tm = pair.tm
    sentinel = torch.tensor([7.0, -3.0, 2.0])
    extra = convert.frame_from_numpy(pair.jax_frame(4), device="cpu")
    added = {}

    def hook():
        with tm.store.lock:
            tm.store.variables.pose.trans[0] = sentinel
            tm.store.version[0] += 1
        added["id"] = tm.store.add(extra)
        added["trans"] = tm.store.variables.pose.trans[added["id"]].clone()

    tm.solve_hook = hook
    err = tm.mapping_step(full=True)  # row 0 is free in this solve
    assert np.isfinite(err)
    assert torch.equal(tm.store.pose(0).trans, sentinel)
    assert torch.equal(tm.store.pose(added["id"]).trans, added["trans"])
    # the compact problem was gathered before the hook: same step as JAX
    pair.jm.mapping_step(full=True)
    assert tm.last_step_iters == pair.jm.last_step_iters
    jv = jax.tree.map(np.asarray, pair.jm.store.variables)
    np.testing.assert_allclose(tm.store.variables.code[1:3].numpy(), jv.code[1:3], atol=1e-6)


def test_store_keeps_each_keyframes_pixel_rows():
    """The prep kernel's pixel rows are built once a keyframe
    (Mapper.frame_tables), kept by the store and gathered by the compact
    step: the window the solve gets holds what photo_prep.pixel_table
    builds from its own pyramids (zeros in its padding, as the store's
    other tables), and prepare_problem keeps it. A store
    that holds pixel rows refuses a frame without them (one converted from
    the JAX package)."""
    from sage_slam_tpu_torch.ops import photo_prep
    from sage_slam_tpu_torch.solver import ba as tba

    pair = Pair()
    tm, scene = pair.tm, pair.scene
    tm.init_one_frame(0.0, scene.images[0])
    for f in range(1, 4):
        pose = tse3.SE3(torch.from_numpy(scene.rot[f]), torch.from_numpy(scene.trans[f]))
        tm.enqueue_keyframe(tm.build_frame(0.1 * f, scene.images[f], pose=pose), [f - 1])
    st = tm.store
    n = st.num_active
    want = photo_prep.pixel_table(st.feat_pyr[:, :n], st.grad_pyr[:, :, :n], tm.mask_flat, tm.cam_pyr)
    assert n == 4 and torch.equal(st.tables.pixel_fg[:n], want)
    with st.lock:
        snap_n, _, snap_vars = st.snapshot()
        problem = tm._compact_step_inputs(snap_n, snap_vars, True)[0]
    w = problem.window  # the n keyframes, then rows the store never wrote (all zero)
    built = photo_prep.pixel_table(w.feat_pyr, w.grad_pyr, w.mask_flat, tm.cam_pyr)
    pixel = w.tables.pixel_fg
    assert pixel.shape[0] > n and torch.equal(pixel[:n], built[:n])
    assert not pixel[n:].any() and not w.feat_pyr[:, n:].any()
    assert tba.prepare_problem(problem, tm.cam_pyr).window.tables.pixel_fg is pixel
    with pytest.raises(ValueError, match="pixel rows"):
        st.add(convert.frame_from_numpy(pair.jax_frame(4), device="cpu"))
    assert st.num_active == n


def test_windowed_problem_and_full_problem_agree():
    """build_problem(window_lo) keeps only window-incident edges, and its
    solve equals the all-edges solve (frozen-frozen edges only add a
    constant)."""
    from sage_slam_tpu_torch.solver import ba as tba

    pair = _grown(5)
    tm = pair.tm
    n = tm.store.num_active
    lo = n - 2
    full = tm.build_problem(window_lo=0)
    win = tm.build_problem(window_lo=lo)
    assert 0 < win.photo_edges.i0.shape[0] < full.photo_edges.i0.shape[0]
    assert bool(((win.photo_edges.i0 >= lo) | (win.photo_edges.i1 >= lo)).all())
    umask = torch.zeros(tm.store.capacity)
    umask[lo:n] = 1.0
    v = tm.store.variables
    sl = lambda p: tba.slice_problem_keyframes(p, n, tm.cam_pyr)  # noqa: E731
    vn = type(v)(tse3.SE3(v.pose.rot[:n], v.pose.trans[:n]), v.code[:n], v.scale[:n])
    out_full = tba.run_ba(vn, sl(full), tm.cam_pyr, tm.cfg.mapper, umask[:n], max_iters=3)
    out_win = tba.run_ba(vn, sl(win), tm.cam_pyr, tm.cfg.mapper, umask[:n], max_iters=3)
    np.testing.assert_allclose(out_full[0].pose.trans.numpy(), out_win[0].pose.trans.numpy(), atol=1e-5)
    np.testing.assert_allclose(out_full[0].code.numpy(), out_win[0].code.numpy(), atol=1e-5)


def test_mapper_contracts(tmp_path):
    """A single keyframe makes no step; mesh= (a one-rank gloo group here)
    takes the sharded step, as JAX's mapping_step_sharded on a 4-device
    mesh does (test_sharded_ba.py's tolerances: error rtol 1e-4, variables
    atol 1e-5); the default device is the card; the store refuses rows
    past its capacity."""
    from jax.sharding import Mesh as JMesh

    from sage_slam_tpu_torch.parallel import launch

    pair = Pair()
    pair.init()
    assert pair.tm.mapping_step() == 0.0 and pair.tm.last_step_iters == 0
    with launch.one_rank("cpu", workdir=str(tmp_path)) as mesh:
        assert pair.tm.mapping_step(mesh=mesh) == 0.0 and pair.tm.last_step_iters == 0
        for f in (1, 2):
            pair.add_keyframe(f)
        err_t = pair.tm.mapping_step(mesh=mesh)
    err_j = pair.jm.mapping_step_sharded(JMesh(np.array(jax.devices()[:4]), ("e",)))
    assert pair.tm.last_step_iters == pair.jm.last_step_iters > 0
    np.testing.assert_allclose(err_t, err_j, rtol=1e-4)
    _assert_vars_close(pair.tm.store.variables, pair.jm.store.variables, 3, pose_atol=1e-5,
                       code_atol=1e-5)
    assert pair.tm.photo_edge_iters == pair.jm.photo_edge_iters
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tmapper.Mapper(pair.tm.cfg, pair.tm.cam_pyr, pair.scene.mask_out,
                           pair.tm.depth_net, pair.tm.feat_net)
    store = KeyframeStore(1, 4, 6, 2, 3, 10, levels=2, device="cpu")
    fr = dataclasses.replace(
        convert.frame_from_numpy(pair.jax_frame(1), device="cpu"), tables=None
    )
    small = dataclasses.replace(
        fr, loc1d=fr.loc1d[:4], homo=fr.homo[:4], bias_flat=fr.bias_flat[:6],
        jac_flat=fr.jac_flat[:6, :2], feat_pyr=fr.feat_pyr[:3, :10], grad_pyr=fr.grad_pyr[:, :3, :10],
        feat_desc_flat=fr.feat_desc_flat[:6, :3], src_feats=fr.src_feats[:2, :4, :3], code=fr.code[:2],
    )
    assert store.add(small) == 0
    with pytest.raises(RuntimeError):
        store.add(small)


def test_clone_copies_the_state_and_steps_alike():
    """Mapper.clone (how the card's step is held against the CPU's): the
    copy takes the same step bit for bit and shares no tensor with the
    source."""
    pair = _grown(4)
    twin = pair.tm.clone("cpu")
    assert twin.store.bias_flat.data_ptr() != pair.tm.store.bias_flat.data_ptr()
    assert twin.photo_edges == pair.tm.photo_edges and twin._pose_anchor == 0
    err_a, err_b = pair.tm.mapping_step(), twin.mapping_step()
    assert err_a == err_b and twin.last_step_iters == pair.tm.last_step_iters
    assert torch.equal(twin.store.variables.code, pair.tm.store.variables.code)
    assert torch.equal(twin.store.tables.packed_fg, pair.tm.store.tables.packed_fg)
    np.testing.assert_array_equal(twin.store.version, pair.tm.store.version)
    loc = torch.as_tensor(np.arange(0, 64))
    fr = twin.build_frame(0.7, pair.scene.images[5], loc1d=loc)
    np.testing.assert_array_equal(fr.loc1d.numpy(), np.arange(0, 64))
