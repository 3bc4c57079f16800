"""Port parity of the loop-closure units: the pose-graph factors
(rel_pose_scale_factor, rel_pose_factor), the rest of the match-geometry
module, the BoW vocabulary (build, transform, descent, the DBoW2 YAML
loader, the database query), the pose-scale graph (linearize, error_only,
optimize, propagate_newer_keyframes), and the port's native runtime,
against the JAX functions on the same numpy inputs (CPU)."""

import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sage_slam_tpu.config import LoopConfig as JLoopConfig
from sage_slam_tpu.demo.voc_builder import load_npz_vocabulary as jload_npz
from sage_slam_tpu.geometry import se3 as jse3
from sage_slam_tpu.loop import pose_graph as jpg
from sage_slam_tpu.loop import vocabulary as jvoc
from sage_slam_tpu.ops import match_geometry as jmg
from sage_slam_tpu.ops import priors as jpriors
from sage_slam_tpu_torch import convert, native
from sage_slam_tpu_torch.config import LoopConfig
from sage_slam_tpu_torch.frontend.slam import SlamSystem
from sage_slam_tpu_torch.geometry import se3 as tse3
from sage_slam_tpu_torch.loop import pose_graph as tpg
from sage_slam_tpu_torch.loop import vocabulary as tvoc
from sage_slam_tpu_torch.ops import match_geometry as tmg
from sage_slam_tpu_torch.ops import priors as tpriors
from sage_slam_tpu_torch.tracker.tracker import convex_hull_area
from tests.test_loop import _chain_poses
from tests.test_match_reproj import scene as mg_scene

torch.set_num_threads(1)

VOC_PATH = "eval_artifacts/bow_voc.npz"


def _t(x):
    return torch.from_numpy(np.array(x))


def _se3(p):
    return tse3.SE3(_t(p.rot), _t(p.trans))


def _close(port, ref, rel, scale=None, msg=""):
    """|port - ref| <= rel * scale (scale: max |ref| by default)."""
    ref = np.asarray(ref)
    scale = np.abs(ref).max() if scale is None else scale
    np.testing.assert_allclose(np.asarray(port), ref, rtol=0, atol=rel * scale, err_msg=msg)


# ---------------------------------------------------------------- factors


def _edge_inputs(seed, e=128):
    """Random poses; pose1 and the target near pose0 / the identity (a
    relative rotation well away from pi, where the float32 derivative of
    the log is ill-conditioned), scales and weights."""
    rng = np.random.default_rng(seed)
    exp = lambda s: jse3.se3_exp(jnp.asarray(rng.standard_normal((e, 6)).astype(np.float32) * s))  # noqa: E731
    p0 = exp(1.0)
    p1 = jse3.compose(p0, exp(0.3))
    tgt = exp(0.3)
    s0, s1, ts0, ts1 = (rng.uniform(0.5, 2.0, e).astype(np.float32) for _ in range(4))
    w = rng.uniform(0.5, 5.0, e).astype(np.float32)
    return p0, p1, tgt, s0, s1, ts0, ts1, w


def test_rel_pose_scale_factor_matches_jax():
    """ata, atb and err of E edges in one call against JAX's vmapped
    per-edge factor (forward-mode AD): within 1e-5 of max |ata| (ata,
    atb) and 1e-5 relative (err)."""
    p0, p1, tgt, s0, s1, ts0, ts1, w = _edge_inputs(0)
    ja, jb, je = jax.jit(jax.vmap(
        lambda r0, t0, r1, t1, a, b, rt, tt, c, d, ww: jpriors.rel_pose_scale_factor(
            jse3.SE3(r0, t0), jse3.SE3(r1, t1), a, b, jse3.SE3(rt, tt), c, d, ww, 1.0, 3.0)
    ))(p0.rot, p0.trans, p1.rot, p1.trans, s0, s1, tgt.rot, tgt.trans, ts0, ts1, w)
    ta, tb, te = tpriors.rel_pose_scale_factor(_se3(p0), _se3(p1), _t(s0), _t(s1), _se3(tgt), _t(ts0),
                                               _t(ts1), _t(w), 1.0, 3.0)
    scale = float(np.abs(np.asarray(ja)).max())
    _close(ta, ja, 1e-5, scale)
    _close(tb, jb, 1e-5, scale)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-5)
    assert ta.shape == (128, 14, 14) and tb.shape == (128, 14)


def test_rel_pose_factor_matches_jax():
    """The pose-only edge, a scalar factor weight: 1e-5 of max |ata|."""
    p0, p1, tgt, *_ = _edge_inputs(1)
    ja, jb, je = jax.jit(jax.vmap(
        lambda r0, t0, r1, t1, rt, tt: jpriors.rel_pose_factor(
            jse3.SE3(r0, t0), jse3.SE3(r1, t1), jse3.SE3(rt, tt), 2.0, 0.5)
    ))(p0.rot, p0.trans, p1.rot, p1.trans, tgt.rot, tgt.trans)
    ta, tb, te = tpriors.rel_pose_factor(_se3(p0), _se3(p1), _se3(tgt), 2.0, 0.5)
    scale = float(np.abs(np.asarray(ja)).max())
    _close(ta, ja, 1e-5, scale)
    _close(tb, jb, 1e-5, scale)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-5)


# ---------------------------------------------------------- match geometry


def _mg_args(s, port):
    f = _t if port else jnp.asarray
    pose = _se3 if port else (lambda p: p)
    if port:
        m = tmg.MatchSet(_t(s["loc0"]).long(), _t(s["homo0"]), _t(s["loc1"]).long(), _t(s["homo1"]),
                         _t(s["valid"]))
    else:
        m = jmg.MatchSet(*(jnp.asarray(s[k]) for k in ("loc0", "homo0", "loc1", "homo1", "valid")))
    return (pose(s["p0"]), pose(s["p1"]), f(s["code0"]), f(s["code1"]), f(s["scale0"]), f(s["scale1"]),
            f(s["bias0"]), f(s["jac0"]), f(s["bias1"]), f(s["jac1"]), m, s["weight"], s["loss_param"])


@pytest.mark.parametrize("seed", [0, 2])
def test_match_geometry_functions_match_jax(seed):
    """match_geometry_jac_error, match_geometry_error and loop_mg_jac_error
    at tests/test_match_reproj.py's shapes (40 matches, 16x20, CS=4): AtA
    and Atb within 1e-5 of max |AtA|, errors within 1e-5 relative, the
    valid count equal."""
    s = mg_scene(seed=seed)
    ja, jb, je, jn = jmg.match_geometry_jac_error(*_mg_args(s, False))
    ta, tb, te, tn = tmg.match_geometry_jac_error(*_mg_args(s, True))
    scale = float(np.abs(np.asarray(ja)).max())
    _close(ta, ja, 1e-5, scale)
    _close(tb, jb, 1e-5, scale)
    np.testing.assert_allclose(float(te), float(je), rtol=1e-5)
    assert float(tn) == float(jn)
    np.testing.assert_allclose(float(tmg.match_geometry_error(*_mg_args(s, True))),
                               float(jmg.match_geometry_error(*_mg_args(s, False))), rtol=1e-5)

    ud0 = np.abs(s["bias0"][s["loc0"]])
    ud1 = np.abs(s["bias1"][s["loc1"]])
    args = (s["scale0"], s["scale1"], ud0, ud1, s["homo0"], s["homo1"], s["valid"])
    ja, jb, je = jmg.loop_mg_jac_error(s["p0"], s["p1"], *map(jnp.asarray, args), s["weight"], s["loss_param"])
    ta, tb, te = tmg.loop_mg_jac_error(_se3(s["p0"]), _se3(s["p1"]), *map(_t, args), s["weight"],
                                       s["loss_param"])
    scale = float(np.abs(np.asarray(ja)).max())
    _close(ta, ja, 1e-5, scale)
    _close(tb, jb, 1e-5, scale)
    np.testing.assert_allclose(float(te), float(je), rtol=1e-5)
    # no valid match: weight * 10 and zeros, in both
    s["valid"] = np.zeros_like(s["valid"])
    ta, tb, te, tn = tmg.match_geometry_jac_error(*_mg_args(s, True))
    assert float(te) == pytest.approx(10 * s["weight"]) and not ta.any() and float(tn) == 0


# --------------------------------------------------------------- vocabulary


def _train_features(seed=0, n=600, c=8):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-1, 1, (6, c)).astype(np.float32) * 3
    return np.concatenate([ctr + rng.normal(0, 0.3, (n // 6, c)).astype(np.float32) for ctr in centers])


@pytest.mark.parametrize("with_docs", [False, True])
def test_build_vocabulary_matches_jax(with_docs):
    """The same numpy k-means from default_rng(seed): an identical tree
    (children, descriptors, word ids) and word weights within 1e-6 (TF-IDF
    from the port's own descent when doc_ids are given)."""
    feats = _train_features()
    docs = np.arange(len(feats)) % 7 if with_docs else None
    jv = jvoc.build_vocabulary(feats, k=3, levels=3, seed=1, doc_ids=docs)
    tv = tvoc.build_vocabulary(feats, k=3, levels=3, seed=1, doc_ids=docs, device="cpu")
    assert (tv.num_words, tv.levels) == (jv.num_words, jv.levels)
    np.testing.assert_array_equal(tv.children.numpy(), np.asarray(jv.children))
    np.testing.assert_array_equal(tv.word_ids.numpy(), np.asarray(jv.word_ids))
    np.testing.assert_array_equal(tv.descriptors.numpy(), np.asarray(jv.descriptors))
    np.testing.assert_allclose(tv.weights.numpy(), np.asarray(jv.weights), atol=1e-6)
    if with_docs:
        assert len(np.unique(tv.weights.numpy())) > 2  # not uniform


def test_transform_on_the_repo_vocabulary():
    """eval_artifacts/bow_voc.npz (585 nodes, 16-dim, 512 words) through
    both loaders: word ids of 4018 random descriptors equal, BoW vectors
    within 1e-6, scores within 1e-6; convert.vocabulary_from_numpy gives
    the loader's vocabulary."""
    jv = jload_npz(VOC_PATH)
    tv = tvoc.load_npz_vocabulary(VOC_PATH, device="cpu")
    assert (tv.num_words, tv.levels, tv.branching) == (512, 3, 8)
    conv = convert.vocabulary_from_numpy(jax.tree.map(np.asarray, jv._asdict()), device="cpu")
    for a, b in zip(conv[:4], tv[:4]):
        assert torch.equal(a, b)
    rng = np.random.default_rng(3)
    desc = np.asarray(jv.descriptors)
    sets = [(desc[rng.integers(1, len(desc), 4018)] + rng.normal(0, 0.05, (4018, 16))).astype(np.float32)
            for _ in range(2)]
    np.testing.assert_array_equal(tvoc.descend_to_words(tv, _t(sets[0])).numpy(),
                                  np.asarray(jvoc.descend_to_words(jv, sets[0])))
    bows = []
    for f in sets:
        jb, tb = jvoc.transform(jv, jnp.asarray(f)), tvoc.transform(tv, _t(f))
        np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-6)
        assert abs(float(tb.sum()) - 1.0) < 1e-5
        bows.append((jb, tb))
    np.testing.assert_allclose(float(tvoc.score_l1(bows[0][1], bows[1][1])),
                               float(jvoc.score_l1(bows[0][0], bows[1][0])), atol=1e-6)


YAML = """%YAML:1.0
vocabulary:
   k: 2
   L: 2
   scoringType: 0
   weightingType: 0
   nodes:
      - { nodeId:1, parentId:0, weight:0., descriptor:"0.5 -1.0 0.25" }
      - { nodeId:2, parentId:0, weight:0., descriptor:"-0.5 1.0
          -0.25" }
      - { nodeId:3, parentId:1, weight:1.5, descriptor:"0.6 -1.1 0.2" }
      - { nodeId:4, parentId:1, weight:0.75, descriptor:"0.4 -0.9 0.3" }
      - { nodeId:5, parentId:2, weight:2.0e-1, descriptor:"-0.4 0.9 -0.3" }
   words:
      - { wordId:0, nodeId:3 }
      - { wordId:1, nodeId:4 }
      - { wordId:2, nodeId:5 }
"""


@pytest.mark.parametrize("gz", [False, True])
def test_load_dbow2_yaml_matches_jax(tmp_path, gz):
    """A small OpenCV-YAML vocabulary (a descriptor across lines, a ragged
    node 2 with one child), plain and gzipped: equal arrays, and equal
    words for a few features."""
    import gzip

    path = tmp_path / ("voc.yml.gz" if gz else "voc.yml")
    (gzip.open if gz else open)(path, "wt").write(YAML)
    jv = jvoc.load_dbow2_yaml(str(path))
    tv = tvoc.load_dbow2_yaml(str(path), device="cpu")
    assert (tv.num_words, tv.levels) == (jv.num_words, jv.levels) == (3, 2)
    for name in ("children", "descriptors", "weights", "word_ids"):
        np.testing.assert_array_equal(getattr(tv, name).numpy(), np.asarray(getattr(jv, name)), err_msg=name)
    feats = np.array([[0.6, -1.0, 0.2], [0.4, -0.95, 0.3], [-0.5, 1.0, -0.2]], np.float32)
    np.testing.assert_array_equal(tvoc.descend_to_words(tv, _t(feats)).numpy(), [0, 1, 2])
    np.testing.assert_array_equal(np.asarray(jvoc.descend_to_words(jv, feats)), [0, 1, 2])


def _databases(capacity, sets, voc_pair):
    jv, tv = voc_pair
    jdb, tdb = jvoc.BowDatabase(jv, capacity), tvoc.BowDatabase(tv, capacity)
    for s in sets:
        jdb.add(jnp.asarray(s))
        tdb.add(_t(s))
    return jdb, tdb


def test_bow_database_query_matches_jax():
    """Top-k over the capacity with the -1e30 sentinel beyond count: ids
    equal, scores and the temporal neighbours' best score within 1e-6; the
    row vectors within 1e-6."""
    rng = np.random.default_rng(1)
    voc_pair = (jload_npz(VOC_PATH), tvoc.load_npz_vocabulary(VOC_PATH, device="cpu"))
    desc = np.asarray(voc_pair[0].descriptors)
    sets = [(desc[rng.integers(1, len(desc), 300)] + rng.normal(0, 0.1, (300, 16))).astype(np.float32)
            for _ in range(5)]
    jdb, tdb = _databases(12, sets, voc_pair)
    np.testing.assert_allclose(tdb.vectors.numpy(), np.asarray(jdb.vectors), atol=1e-6)
    assert tdb.count == jdb.count == 5
    for q, top_k, conns in ((2, 3, [1]), (4, 8, [0, 3]), (0, 20, [])):
        js, ji, jm = jdb.query(jdb.vectors[q], top_k, conn_ids=conns)
        ts, ti, tm = tdb.query(tdb.vectors[q], top_k, conn_ids=conns)
        assert ji[0] == ti[0] == q
        np.testing.assert_array_equal(ti[:5], ji[:5])
        np.testing.assert_allclose(ts, js, atol=1e-6)
        assert abs(tm - jm) < 1e-6
        assert (ts[5:] < -1e29).all() and len(ts) == min(top_k, 12)


def test_bow_query_ties_at_the_similarity_gate():
    """Tied scores (duplicate rows) exactly at global_sim_ratio * max_sim:
    whatever order torch.topk gives a tie, the global loop's candidates
    (SlamSystem._global_candidates, scores descending, a break at the first
    one under the gate) equal the JAX scan's on JAX's query."""
    rng = np.random.default_rng(2)
    voc_pair = (jload_npz(VOC_PATH), tvoc.load_npz_vocabulary(VOC_PATH, device="cpu"))
    desc = np.asarray(voc_pair[0].descriptors)
    a, b, c = ((desc[rng.integers(1, len(desc), 200)] + rng.normal(0, 0.1, (200, 16))).astype(np.float32)
               for _ in range(3))
    mix = np.concatenate([c[:150], a[:50]])
    # rows 2, 5, 9 and 12 hold the same vectors, so their scores tie
    rows = [c, c, a, b, b, a, c, c, c, a, b, b, a, mix]
    jdb, tdb = _databases(16, rows, voc_pair)
    query = 13
    conn = [2]  # max_sim = the score of row 2 = the tie value of rows 2, 5, 9, 12
    for ratio in (1.0, 0.999, 1.001):
        lcfg = SimpleNamespace(global_active_window=2, global_sim_ratio=ratio)
        js, ji, jm = jdb.query(jdb.vectors[query], 20, conn_ids=conn)
        ts, ti, tm = tdb.query(tdb.vectors[query], 20, conn_ids=conn)
        np.testing.assert_allclose(ts, js, atol=1e-6)
        rejected = []
        fake = SimpleNamespace(cfg=SimpleNamespace(loop=lcfg), store=SimpleNamespace(link_exists=lambda x, y: False),
                               _reject=lambda *r: rejected.append(r))
        port = SlamSystem._global_candidates(fake, query, ts, ti, tm)
        ref, stop = [], None
        for s, cid in zip(js, ji):  # the JAX scan (sage_slam_tpu/frontend/slam.py:676-693)
            if abs(int(cid) - query) < lcfg.global_active_window:
                continue
            if s < lcfg.global_sim_ratio * jm:
                stop = float(s)
                break
            ref.append(int(cid))
        assert sorted(port) == sorted(ref), ratio
        # the candidate the scan stopped at is the one rejection, at its score
        assert stop is not None and stop > tvoc.EMPTY_SCORE
        [(q, _, gate, value, limit)] = rejected
        assert (q, gate) == (query, "sim") and value == pytest.approx(stop, abs=1e-6) and value < limit
        if ratio == 1.0:
            assert {2, 5, 9} <= set(port)  # 12 is inside the active window


# -------------------------------------------------------------- pose graph


def _drift_chain(dcs_loop: bool):
    """tests/test_loop.py's drift chain: 5 keyframes, drifted odometry
    edges both ways, a loop edge 4 <-> 0 at the true relative pose; as JAX
    and port structures."""
    k = 5
    cfg = JLoopConfig()
    true_poses = _chain_poses(k, [0.1, 0.0, 0.05, 0.0, 0.0, 0.02])
    drift = _chain_poses(k, [0.12, 0.01, 0.05, 0.0, 0.005, 0.02])
    drift_scale = np.array([1.0, 1.05, 1.1, 1.16, 1.21], np.float32)

    def rel(p, ia, ib):
        return jse3.compose(jse3.inverse(jse3.SE3(p.rot[ib], p.trans[ib])), jse3.SE3(p.rot[ia], p.trans[ia]))

    rows = []
    for a in range(k - 1):
        r = rel(drift, a, a + 1)
        rows.append((a, a + 1, r, drift_scale[a], drift_scale[a + 1], cfg.pose_graph_local_link_weight, 0.0))
        rows.append((a + 1, a, jse3.inverse(r), drift_scale[a + 1], drift_scale[a],
                     cfg.pose_graph_local_link_weight, 0.0))
    r = rel(true_poses, 4, 0)
    rows.append((4, 0, r, 1.0, 1.0, cfg.pose_graph_global_link_weight, 1.0))
    rows.append((0, 4, jse3.inverse(r), 1.0, 1.0, cfg.pose_graph_global_link_weight, 1.0))
    col = lambda i, dt=np.float32: np.array([row[i] for row in rows], dt)  # noqa: E731
    trot = np.stack([np.asarray(row[2].rot) for row in rows])
    ttr = np.stack([np.asarray(row[2].trans) for row in rows])
    is_loop = col(6) if dcs_loop else None
    jedges = jpg.PoseScaleEdges(jnp.asarray(col(0, np.int32)), jnp.asarray(col(1, np.int32)), jnp.asarray(trot),
                                jnp.asarray(ttr), jnp.asarray(col(3)), jnp.asarray(col(4)), jnp.asarray(col(5)),
                                jnp.ones(len(rows)), None if is_loop is None else jnp.asarray(is_loop))
    tedges = tpg.PoseScaleEdges(_t(col(0, np.int64)), _t(col(1, np.int64)), _t(trot), _t(ttr), _t(col(3)),
                                _t(col(4)), _t(col(5)), torch.ones(len(rows)),
                                None if is_loop is None else _t(is_loop))
    pv = np.zeros(k, np.float32)
    pv[0] = 1
    sv = pv.copy()
    sv[4] = 1
    sw = np.full(k, cfg.pose_graph_scale_prior_weight, np.float32)
    sw[0] = 100.0
    jpr = jpg.PoseScalePriors(jnp.asarray(pv), drift, 1.0e8, jnp.asarray(sv), jnp.ones(k), jnp.asarray(sw))
    tpr = tpg.PoseScalePriors(_t(pv), _se3(drift), 1.0e8, _t(sv), torch.ones(k), _t(sw))
    jvars = jpg.make_pose_scale_variables(drift, jnp.asarray(drift_scale))
    tvars = tpg.make_pose_scale_variables(_se3(drift), _t(drift_scale))
    return cfg, (jvars, jedges, jpr), (tvars, tedges, tpr)


@pytest.mark.parametrize("dcs_phi", [0.0, 0.05])
def test_pose_graph_linearize_matches_jax(dcs_phi):
    """linearize (H, b, total) and error_only on the drift chain, Gaussian
    and with the Geman-McClure loop kernel: within 1e-5 of max |H| and 1e-5
    relative."""
    cfg, (jv, je, jp), (tv, te, tp) = _drift_chain(dcs_loop=True)
    jh, jb, jt = jax.jit(lambda v: jpg.linearize(v, je, jp, cfg, dcs_phi))(jv)
    th, tb, tt = tpg.linearize(tv, te, tp, LoopConfig(), dcs_phi)
    scale = float(np.abs(np.asarray(jh)).max())
    _close(th, jh, 1e-5, scale)
    _close(tb, jb, 1e-5, scale)
    np.testing.assert_allclose(float(tt), float(jt), rtol=1e-5)
    np.testing.assert_allclose(float(tpg.error_only(tv, te, tp, LoopConfig(), dcs_phi)),
                               float(jax.jit(lambda v: jpg.error_only(v, je, jp, cfg, dcs_phi))(jv)),
                               rtol=1e-5)
    # the robust kernel lowers the loop edges' error
    if dcs_phi > 0:
        assert float(tt) < float(tpg.linearize(tv, te, tp, LoopConfig())[2])


@pytest.mark.parametrize("dcs_phi", [0.0, 0.05])
def test_pose_graph_optimize_matches_jax(dcs_phi):
    """optimize on test_loop.py's drift chain (30 iterations): equal
    iterations, poses and scales within 1e-5, the error within 1e-4
    relative; the loop pulls the drift back."""
    cfg, (jv, je, jp), (tv, te, tp) = _drift_chain(dcs_loop=True)
    k = 5
    jo, jerr, jit = jax.jit(lambda v: jpg.optimize(v, je, jp, cfg, jnp.ones(k), max_iters=30,
                                                   dcs_phi=dcs_phi))(jv)
    to, terr, tit = tpg.optimize(tv, te, tp, LoopConfig(), torch.ones(k), max_iters=30, dcs_phi=dcs_phi)
    assert tit == int(jit)
    np.testing.assert_allclose(to.pose.rot.numpy(), np.asarray(jo.pose.rot), atol=1e-5)
    np.testing.assert_allclose(to.pose.trans.numpy(), np.asarray(jo.pose.trans), atol=1e-5)
    np.testing.assert_allclose(to.scale.numpy(), np.asarray(jo.scale), atol=1e-5)
    np.testing.assert_allclose(float(terr), float(jerr), rtol=1e-4)
    assert float(terr) < 0.2 * float(tpg.error_only(tv, te, tp, LoopConfig(), dcs_phi))


def test_propagate_newer_keyframes_matches_jax():
    """Rigid + scaled propagation: test_loop.py's case and a random one,
    within 1e-6 of JAX."""
    rng = np.random.default_rng(4)
    k = 6
    poses = _chain_poses(k, [0.1, 0.02, 0.0, 0.01, 0.0, 0.03])
    new = jse3.compose(jse3.se3_exp(jnp.asarray(rng.standard_normal((k, 6)).astype(np.float32) * 0.1)), poses)
    scales = rng.uniform(0.8, 1.2, k).astype(np.float32)
    new_scales = rng.uniform(0.8, 1.2, k).astype(np.float32)
    jout = jpg.propagate_newer_keyframes(poses, jnp.asarray(scales), new, jnp.asarray(new_scales), 2, [3, 5])
    tout = tpg.propagate_newer_keyframes(_se3(poses), _t(scales), _se3(new), _t(new_scales), 2, [3, 5])
    assert sorted(tout) == sorted(jout) == [3, 5]
    for i in (3, 5):
        np.testing.assert_allclose(tout[i][0].rot.numpy(), np.asarray(jout[i][0].rot), atol=1e-6)
        np.testing.assert_allclose(tout[i][0].trans.numpy(), np.asarray(jout[i][0].trans), atol=1e-6)
        np.testing.assert_allclose(float(tout[i][1]), float(jout[i][1]), rtol=1e-6)
    # test_loop.py's case: +0.1 x from the old keyframe 1, doubled
    p4 = _chain_poses(4, [0.1, 0, 0, 0, 0, 0])
    moved = jse3.SE3(p4.rot, p4.trans.at[1].add(jnp.asarray([0.5, 0, 0.0])))
    out = tpg.propagate_newer_keyframes(_se3(p4), torch.ones(4), _se3(moved), torch.tensor([1.0, 2.0, 1.0, 1.0]),
                                        1, [2, 3])
    np.testing.assert_allclose(out[2][0].trans.numpy(), np.asarray(moved.trans[1]) + [0.2, 0, 0], atol=1e-6)
    assert float(out[2][1]) == pytest.approx(2.0)


# ----------------------------------------------------------- native runtime


def test_native_runtime_builds_into_the_port_build_directory():
    """The port's runtime is built from its own copy of pipeline.cpp into
    sage_slam_tpu_torch/_build/ and never touches sage_slam_tpu/native/
    (its files' bytes and times stay as they were)."""
    from pathlib import Path

    from sage_slam_tpu_torch import _build

    root = Path(__file__).resolve().parent.parent
    jax_native = root / "sage_slam_tpu" / "native"
    before = {p.name: (p.stat().st_mtime_ns, p.read_bytes()) for p in jax_native.iterdir() if p.is_file()}
    lib = native.load()
    assert native.SOURCE == root / "sage_slam_tpu_torch" / "native" / "pipeline.cpp"
    assert Path(lib._name).parent == _build.BUILD_DIR and Path(lib._name) == native.library_path()
    after = {p.name: (p.stat().st_mtime_ns, p.read_bytes()) for p in jax_native.iterdir() if p.is_file()}
    assert after == before
    assert "sage_slam_tpu/native" not in Path(native.__file__).read_text().replace("sage_slam_tpu_torch", "")


def test_native_hull_and_median():
    """The native hull against the port's tracker.convex_hull_area within
    1e-6 relative; the median against numpy's within 1e-6."""
    rng = np.random.default_rng(0)
    pts = rng.uniform(-3, 5, (4018, 2)).astype(np.float32)
    a_py = convex_hull_area(pts)
    assert abs(native.convex_hull_area(pts) - a_py) / a_py < 1e-6
    assert native.convex_hull_area(pts[:2]) == 0.0
    for n in (1001, 1000):
        v = rng.standard_normal(n).astype(np.float32)
        assert abs(native.median(v) - float(np.median(v))) < 1e-6


def test_native_queue_worker_and_profiler():
    """FIFO queue with a timed-out pop; a 50 Hz worker runs 5-40 times in
    0.35 s; a worker draining the queue sees every item in order."""
    q = native.TaskQueue()
    q.push(42)
    q.push(7)
    assert len(q) == 2 and q.pop() == 42 and q.pop() == 7
    assert q.pop(timeout_ms=10) == -1

    rt = native.Runtime()
    count = {"n": 0}
    processed = []

    def task():
        count["n"] += 1

    def drain():
        item = q.pop(timeout_ms=20)
        if item >= 0:
            processed.append(item)

    rt.spawn("count", task, frequency_hz=50.0)
    rt.spawn("drain", drain, frequency_hz=100.0)
    for i in range(5):
        q.push(i)
        time.sleep(0.02)
    time.sleep(0.25)
    rt.stop_all()
    rt.join_all()
    rt.close()
    rt.check()
    assert 5 <= count["n"] <= 40
    assert processed == [0, 1, 2, 3, 4]


def test_native_worker_exception_is_kept_and_stops_the_workers():
    """A worker that raises: the exception is kept (not printed and
    dropped), every worker stops, and check() re-raises it on the caller."""
    rt = native.Runtime()
    calls = {"bad": 0, "good": 0}

    def bad():
        calls["bad"] += 1
        if calls["bad"] == 3:
            raise ValueError("boom")

    def good():
        calls["good"] += 1

    rt.spawn("bad", bad, frequency_hz=200.0)
    rt.spawn("good", good, frequency_hz=200.0)
    deadline = time.time() + 5
    while rt.error is None and time.time() < deadline:
        time.sleep(0.01)
    time.sleep(0.1)
    frozen = dict(calls)
    time.sleep(0.1)
    assert calls == frozen  # both stopped
    rt.join_all()
    with pytest.raises(RuntimeError, match="'bad' failed") as info:
        rt.check()
    assert isinstance(info.value.__cause__, ValueError) and calls["bad"] == 3
    rt.close()
