"""Port parity of eval/gt_probe.py against the JAX package (CPU).

build_gt_map on tests/test_torch_error_budget.py's scene and weights
(the first 10 frames of the 64-frame Bowl3D orbit at 64x80 input / 32x40
output, oracle depth, raw-image features, stride 3: 4 keyframes at
frames 0, 3, 6, 9), the port drawing JAX's photometric ids. Held: the GT
map's state; grad_report's error and gradient RMS per term subset to 1e-4
relative; section_report's argmins at 5 steps; walk_report at 2 rounds
(equal last-step LM iterations, per-keyframe errors to 1e-4, the numbers to 1e-4
relative or one rounding step of its 5-decimal report)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sage_slam_tpu.eval.error_budget as jeb_mod
from sage_slam_tpu import config as jconfig
from sage_slam_tpu.eval import gt_probe as jgp
from sage_slam_tpu.io.dataset import Bowl3DInterface as JBowl3D
from sage_slam_tpu.models import depth_network as jdn
from sage_slam_tpu.models import feature_network as jfn
from sage_slam_tpu_torch import config as tconfig
from sage_slam_tpu_torch.eval import error_budget as teb
from sage_slam_tpu_torch.eval import gt_probe as tgp
from sage_slam_tpu_torch.io.dataset import Bowl3DInterface as TBowl3D
from tests.test_torch_error_budget import BOWL, DEPTH, FEAT, _cfg, _nets

torch.set_num_threads(1)

PROBE = dict(stride=3, back=2)


@pytest.fixture(scope="module")
def gt_maps():
    """build_gt_map in both packages on the same orbit (4 keyframes at
    frames 0, 3, 6, 9), the port drawing JAX's ids."""
    td, tf, jd, jf = _nets()
    jdata, tdata = JBowl3D(**BOWL), TBowl3D(**BOWL)
    real, real_port = jeb_mod.build_system, teb.build_system

    def jax_build(cfg, data, depth_mode="oracle", feat_mode="handcrafted", **kw):
        return real(cfg, data, depth_mode, feat_mode, depth_params=jd, feat_params=jf,
                    depth_cfg=jdn.DepthNetConfig(**DEPTH), feat_cfg=jfn.FeatureNetConfig(**FEAT))

    def port_build(cfg, data, depth_mode="oracle", feat_mode="handcrafted", device=None):
        sys_ = real_port(cfg, data, depth_mode, feat_mode, depth_net=td, feat_net=tf, device=device)
        sys_.mapper.location_source = locations
        return sys_

    jcfg, tcfg = _cfg(jconfig), _cfg(tconfig)
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jeb_mod, "build_system", jax_build)
        jsys, jids, jts = jgp.build_gt_map(jcfg, jdata, **PROBE)
        valid, n = jsys.mapper.valid_loc1d, jsys.mapper.num_samples

        def locations(timestamp):
            key = jax.random.key(int(timestamp * 1e6) & 0x7FFFFFFF)
            return np.asarray(jnp.take(valid, jax.random.permutation(key, valid.shape[0])[:n]))

        mp.setattr(teb, "build_system", port_build)
        tsys, tids, tts = tgp.build_gt_map(tcfg, tdata, device="cpu", **PROBE)
    finally:
        mp.undo()
    assert (tids, tts) == (jids, jts) == ([0, 1, 2, 3], [0, 3, 6, 9])
    return jsys, tsys, jdata, tdata, jts


def test_build_gt_map_matches_jax(gt_maps):
    jsys, tsys, *_ = gt_maps
    jv, tv = jax.tree.map(np.asarray, jsys.mapper.store.variables), tsys.mapper.store.variables
    n = tsys.store.num_active
    np.testing.assert_allclose(tv.pose.trans[:n].numpy(), jv.pose.trans[:n], atol=1e-6)
    np.testing.assert_allclose(tv.pose.rot[:n].numpy(), jv.pose.rot[:n], atol=1e-6)
    np.testing.assert_allclose(tv.scale[:n].numpy(), jv.scale[:n], rtol=1e-5)
    assert float(tv.scale[0]) == 1.0
    assert tsys.mapper.photo_edges == jsys.mapper.photo_edges
    assert tsys.mapper.geo_edges == jsys.mapper.geo_edges


def test_grad_report_matches_jax(gt_maps):
    jsys, tsys, *_ = gt_maps
    jr, tr = jgp.grad_report(jsys), tgp.grad_report(tsys)
    assert list(tr) == list(jr)
    for label, row in jr.items():
        for k, v in row.items():
            np.testing.assert_allclose(tr[label][k], v, rtol=1e-4, atol=1e-9, err_msg=f"{label} {k}")
    assert jr["photo"]["error"] > 0


def test_section_report_argmins_match_jax(gt_maps):
    jsys, tsys, *_ = gt_maps
    jr = jgp.section_report(jsys, 2, steps=5)
    tr = tgp.section_report(tsys, 2, steps=5)
    assert list(tr) == list(jr)
    for key, row in jr.items():
        assert tr[key]["argmin_frac"] == row["argmin_frac"], key
        assert tr[key]["curvature_ok"] == row["curvature_ok"], key


def test_walk_report_matches_jax(gt_maps):
    """Two full-graph rounds from GT (after the read-only reports above)."""
    jsys, tsys, jdata, tdata, kf_ts = gt_maps
    jr = jgp.walk_report(jsys, jdata, kf_ts, refine_rounds=2)
    tr = tgp.walk_report(tsys, tdata, kf_ts, refine_rounds=2)
    assert tsys.mapper.last_step_iters == jsys.mapper.last_step_iters
    assert tsys.mapper.last_step_converged == jsys.mapper.last_step_converged
    assert tsys.mapper.step_iters_total > 0
    assert set(tr) == set(jr) and tr["keyframes"] == jr["keyframes"]
    np.testing.assert_allclose(tr["kf_trans_err_raw"], jr["kf_trans_err_raw"], atol=1e-4)
    for k in ("span", "kf_ate_sim3", "scale_min", "scale_max", "code_norm_max"):
        assert abs(tr[k] - jr[k]) <= max(1e-4 * abs(jr[k]), 1e-5 + 1e-12), (k, tr[k], jr[k])
    print("walk", {k: (tr[k], jr[k]) for k in jr if k != "kf_trans_err_raw"})


def test_cli_report_has_the_jax_reports_layout(tmp_path):
    """gt_probe's CLI on the CPU (8 frames at 64x80, stride 4: 2 keyframes,
    one refine round): the keys of the JAX CLI's recorded reports
    (docs/gt_probe_r05_32x40.json, whose sections ran, and the later
    docs/gt_probe_r05_64x80.json for the flags)."""
    import json
    import os

    path = str(tmp_path / "gp.json")
    report = tgp.main(["--device", "cpu", "--num_frames", "8", "--height", "64", "--width", "80",
                       "--refine_rounds", "1", "--out", path])
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "docs", "gt_probe_r05_32x40.json")) as f:
        ref = json.load(f)
    with open(os.path.join(root, "docs", "gt_probe_r05_64x80.json")) as f:
        flags = set(json.load(f)["config"])
    assert set(report) == set(ref) and report["keyframes"] == 2
    assert set(report["config"]) == flags | {"device"}
    assert set(report["sections_at_gt"]) == set(ref["sections_at_gt"])
    assert set(report["walk_from_gt"]) == set(ref["walk_from_gt"])
    assert set(report["grad_at_gt"]) <= set(ref["grad_at_gt"]) | {"reproj"}
    with open(path) as f:
        assert json.load(f) == report
