"""Port parity of eval/error_budget.py against the JAX package (CPU).

The scene is the first 10 frames of the 64-frame Bowl3D orbit at 64x80
input / 32x40 output (the JAX package's records call this operating point
"32x40") with the oracle
depth and the raw-image features, as the error budget's A-C rows and the
probe use them. Both packages see the same weights: the port's seeded
init of narrow networks, handed to JAX as its param tree (the oracle and
the image features use no network output). JAX's photometric ids and
keypoints are injected into the port (Mapper.location_source,
SlamSystem.keypoint_source). The store holds 8 keyframes and a frame
512 photometric samples. The LM budgets stop before float32 ties at
the optimum decide an accept test (ROADMAP Queue 3): the tracker at 4 LM
iterations, mapping steps at 3, refine_mapping at 2 rounds.

Held: run_stage's trajectories to 1e-4 and its report's numbers to 1e-4
relative, or one rounding step (the report rounds to 5 decimals) where
that is larger; build_vocabulary_for's tree and weights. The probe of
eval/gt_probe.py, which builds on this module's systems, is held in
tests/test_torch_gt_probe.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sage_slam_tpu import config as jconfig
from sage_slam_tpu.eval import error_budget as jeb
from sage_slam_tpu.io.dataset import Bowl3DInterface as JBowl3D
from sage_slam_tpu.models import depth_network as jdn
from sage_slam_tpu.models import feature_network as jfn
from sage_slam_tpu.tracker import matcher as jmatcher
from sage_slam_tpu_torch import config as tconfig
from sage_slam_tpu_torch.eval import error_budget as teb
from sage_slam_tpu_torch.frontend import slam as tslam
from sage_slam_tpu_torch.io.dataset import Bowl3DInterface as TBowl3D
from sage_slam_tpu_torch.models import depth_network as tdn
from sage_slam_tpu_torch.models import feature_network as tfn
from tests.test_torch_slam import _port_init

torch.set_num_threads(1)

# the first 10 frames of the 64-frame orbit's motion: 9/63 of an orbit
BOWL = dict(num_frames=10, height=64, width=80, seed=0, orbit_radius=0.22, rot_amp=0.25,
            mask_margin=6, orbits=9 / 63)
DEPTH = dict(filter_list=(4, 8, 16), bottleneck=16, bias_inner=(8, 1), basis_inner=((8, 16),))
FEAT = dict(filter_list=(4, 8, 16), bottleneck=16, desc_inner=(8, 16), map_inner=(8, 16))


def _cfg(mod):
    cfg = mod.SlamConfig(net_input_size=(64, 80), net_output_size=(32, 40), max_keyframes=8,
                         loop=mod.LoopConfig(global_active_window=6))
    return dataclasses.replace(
        cfg, tracker=dataclasses.replace(cfg.tracker, max_num_iters=4),
        mapper=dataclasses.replace(cfg.mapper, max_gn_iters=3, pho_num_samples=512),
    )


def _nets():
    """(port depth net, port feature net, JAX depth params, JAX feature
    params): the port's seeded init on both sides."""
    dcfg, fcfg = jdn.DepthNetConfig(**DEPTH), jfn.FeatureNetConfig(**FEAT)
    key = jax.random.key(0)
    jd, jf = _port_init(jdn, tdn, 0)(key, dcfg), _port_init(jfn, tfn, 1)(key, fcfg)
    td = tdn.init_network(torch.Generator().manual_seed(0), tdn.DepthNetConfig(**DEPTH))
    tf = tfn.init_network(torch.Generator().manual_seed(1), tfn.FeatureNetConfig(**FEAT))
    return td, tf, jd, jf


def _inject_jax_ids(tsys, jsys):
    jm = jsys.mapper
    valid, n = jm.valid_loc1d, jm.num_samples
    kp = tsys.cfg.tracker.desc_num_keypoints

    def locations(timestamp):
        key = jax.random.key(int(timestamp * 1e6) & 0x7FFFFFFF)
        return np.asarray(jnp.take(valid, jax.random.permutation(key, valid.shape[0])[:n]))

    def keypoints(kf_id):
        return np.asarray(jmatcher.select_keypoints(jax.random.key(tslam._match_seed(kf_id)), valid, kp))

    tsys.mapper.location_source = locations
    tsys.keypoint_source = keypoints


def _systems():
    td, tf, jd, jf = _nets()
    jdata, tdata = JBowl3D(**BOWL), TBowl3D(**BOWL)
    jsys = jeb.build_system(_cfg(jconfig), jdata, "oracle", "image", depth_params=jd, feat_params=jf,
                            depth_cfg=jdn.DepthNetConfig(**DEPTH), feat_cfg=jfn.FeatureNetConfig(**FEAT))
    tsys = teb.build_system(_cfg(tconfig), tdata, "oracle", "image", depth_net=td, feat_net=tf,
                            device="cpu")
    _inject_jax_ids(tsys, jsys)
    return jsys, tsys, jdata, tdata


@pytest.fixture(scope="module", params=["tracker", "window", "refine"])
def stage(request):
    jsys, tsys, jdata, tdata = _systems()
    jr = jeb.run_stage(jsys, jdata, request.param, refine_iters=2)
    tr = teb.run_stage(tsys, tdata, request.param, refine_iters=2)
    return request.param, jsys, tsys, jr, tr


def test_run_stage_trajectories_match_jax(stage):
    name, jsys, tsys, _, _ = stage
    jt, tt = jsys.finalized_trajectory(), tsys.finalized_trajectory()
    assert len(tt) == len(jt) == BOWL["num_frames"]
    for (jts, jp), (tts, tp) in zip(jt, tt):
        assert tts == jts
        np.testing.assert_allclose(tp.trans.numpy(), np.asarray(jp.trans), atol=1e-4, err_msg=name)
        np.testing.assert_allclose(tp.rot.numpy(), np.asarray(jp.rot), atol=1e-4, err_msg=name)
    jk, tk = jsys.keyframe_trajectory(), tsys.keyframe_trajectory()
    assert [t for t, _ in tk] == [t for t, _ in jk]
    for (_, jp), (_, tp) in zip(jk, tk):
        np.testing.assert_allclose(tp.trans.numpy(), np.asarray(jp.trans), atol=1e-4, err_msg=name)
    if name != "tracker":
        assert tsys.mapper.step_iters_total > 0


def test_run_stage_report_matches_jax(stage):
    name, _, _, jr, tr = stage
    assert set(tr) == set(jr)
    for k in ("frames", "keyframes", "tracking_lost", "global_loops"):
        assert tr[k] == jr[k], (name, k)
    assert tr["keyframes"] >= 3
    for k, v in jr.items():
        if k in ("frames", "keyframes", "tracking_lost", "global_loops", "wall_s"):
            continue
        assert abs(tr[k] - v) <= max(1e-4 * abs(v), 1e-5 + 1e-12), (name, k, tr[k], v)
    print(name, {k: (tr[k], jr[k]) for k in jr if k != "wall_s"})


def test_build_vocabulary_for_matches_jax():
    """The vocabulary from the image-mode descriptors of the same frames:
    equal tree and words, weights to 1e-6."""
    jsys, tsys, jdata, tdata = _systems()
    jv = jeb.build_vocabulary_for(jdata, jsys.cfg, "image", jsys.mapper.feat_params, jsys.mapper.feat_cfg,
                                  num_frames=5, points_per_frame=40)
    tv = teb.build_vocabulary_for(tdata, tsys.cfg, tsys.mapper.feat_net, num_frames=5,
                                  points_per_frame=40)
    assert tv.num_words == jv.num_words and tv.levels == jv.levels
    np.testing.assert_array_equal(tv.children.numpy(), np.asarray(jv.children))
    np.testing.assert_array_equal(tv.word_ids.numpy(), np.asarray(jv.word_ids))
    np.testing.assert_allclose(tv.descriptors.numpy(), np.asarray(jv.descriptors), atol=1e-6)
    np.testing.assert_allclose(tv.weights.numpy(), np.asarray(jv.weights), atol=1e-6)
