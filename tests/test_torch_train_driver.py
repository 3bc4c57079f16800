"""The port's train() driver (sage_slam_tpu_torch/training/train.py) at
tests/test_training.py::test_train_driver_with_eval_split's config: the
held-out eval split, the separate -> joint phase switch, scalar and image
logs, checkpoints and resume, the plateau stopper's per-phase snapshots and
its jump to the joint phase, and the time budget.

Its tie to the JAX package is the checkpoint it writes, which JAX's
load_checkpoint must read back leaf for leaf. JAX's driver is not rerun
here (tests/test_training.py runs it).
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from sage_slam_tpu.models import depth_network as jdepth
from sage_slam_tpu.models import feature_network as jfeat
from sage_slam_tpu.training import discriminator as jdisc
from sage_slam_tpu.training import train as jtrain
from sage_slam_tpu_torch.models.depth_network import DepthNetConfig
from sage_slam_tpu_torch.models.feature_network import FeatureNetConfig
from sage_slam_tpu_torch.training import dataset, discriminator, train

torch.set_num_threads(1)

H, W, CS, FS = 16, 20, 4, 8
DEPTH = DepthNetConfig(filter_list=(4, 8), bottleneck=8, bias_inner=(8, 1), basis_inner=((8, CS),))
FEAT = FeatureNetConfig(filter_list=(4, 8), bottleneck=8, desc_inner=(8, FS), map_inner=(8, FS))
DISC = discriminator.DiscConfig(img_height=H, img_width=W, num_blocks=2, filter_base=4)


@pytest.fixture(scope="module")
def triplets_and_cam():
    ds = dataset.SyntheticTripletDataset(H, W, num_keypoints=16)
    return [ds.sample() for _ in range(3)], ds.cam


def _cfg(**kw):
    return train.TrainConfig(pyramid_levels=2, ba_iters=2, num_photo_samples=32, **kw)


def test_train_driver_with_eval_split(triplets_and_cam, tmp_path):
    """Both phases over 2 training + 1 held-out triplet, logs, image
    panels, a checkpoint JAX's load_checkpoint reads back leaf for leaf, and
    a resume with nothing left to do."""
    triplets, cam = triplets_and_cam
    cfg = _cfg(separate_train_epoch=1, eval_fraction=0.34)
    log = os.path.join(tmp_path, "scalars.jsonl")
    ckpt = os.path.join(tmp_path, "ckpt.npz")
    imgdir = os.path.join(tmp_path, "images")
    state, history = train.train(triplets, cam, DEPTH, FEAT, DISC, cfg, num_epochs=2,
                                 checkpoint_path=ckpt, log_path=log, image_log_dir=imgdir,
                                 device="cpu")
    pngs = os.listdir(imgdir)
    for tag in ("pred_depth", "gt_depth", "depth_err"):
        assert sum(tag in p for p in pngs) == 2, tag
    assert state.epoch == 2 and state.step == 4 and state.opt_state["count"] == 4
    assert [h["joint"] for h in history] == [False, True]
    for h in history:
        assert np.isfinite(h["eval"]["loss"]) and "depth" in h["eval"]
    assert "flow" in history[1]["eval"] and "flow" not in history[0]["eval"]
    lines = [json.loads(line) for line in open(log)]
    assert [r["tag"] for r in lines] == ["train", "train", "eval"] * 2
    assert all(np.isfinite(v) for r in lines for k, v in r.items() if k not in ("tag", "step"))

    # JAX reads the port's checkpoint
    jstate, _, _ = jtrain.init_state(
        jax.random.key(0),
        jdepth.DepthNetConfig(filter_list=(4, 8), bottleneck=8, bias_inner=(8, 1), basis_inner=((8, CS),)),
        jfeat.FeatureNetConfig(filter_list=(4, 8), bottleneck=8, desc_inner=(8, FS), map_inner=(8, FS)),
        jdisc.DiscConfig(img_height=H, img_width=W, num_blocks=2, filter_base=4),
        jtrain.TrainConfig(pyramid_levels=2),
    )
    jr = jtrain.load_checkpoint(ckpt, jstate)
    assert (int(jr.step), jr.epoch) == (4, 2)
    for (name, t), j in zip(train.param_leaves(state.params), jax.tree.flatten(jr.params)[0]):
        np.testing.assert_array_equal(np.asarray(j), t.detach().numpy(), err_msg=name)

    # resume restores the epoch counter: nothing left to do
    state2, history2 = train.train(triplets, cam, DEPTH, FEAT, DISC, cfg, num_epochs=2,
                                   checkpoint_path=ckpt, resume=True, device="cpu")
    assert state2.epoch == 2 and history2 == []
    for (_, a), (_, b) in zip(train.param_leaves(state2.params), train.param_leaves(state.params)):
        assert torch.equal(a.detach(), b.detach())


def test_resume_continues_from_the_checkpoint(triplets_and_cam, tmp_path):
    """A run stopped after epoch 0 and resumed for epoch 1 runs only the
    joint epoch, from the checkpoint's parameters and step."""
    triplets, cam = triplets_and_cam
    cfg = _cfg(separate_train_epoch=1, eval_fraction=0.34)
    ckpt = os.path.join(tmp_path, "ckpt.npz")
    first, h1 = train.train(triplets, cam, DEPTH, FEAT, DISC, cfg, num_epochs=1, checkpoint_path=ckpt,
                            device="cpu")
    assert [h["epoch"] for h in h1] == [0] and first.epoch == 1
    second, h2 = train.train(triplets, cam, DEPTH, FEAT, DISC, cfg, num_epochs=2, checkpoint_path=ckpt,
                             resume=True, device="cpu")
    assert [(h["epoch"], h["joint"]) for h in h2] == [(1, True)]
    assert second.epoch == 2 and second.step == 4


def test_plateau_jumps_to_the_joint_phase_and_returns_its_snapshot(triplets_and_cam, tmp_path):
    """With patience 1 and an improvement no epoch can make (99%), the
    separate phase snapshots epoch 0, stalls at epoch 1 and jumps to the
    joint phase (epoch 3) from that snapshot; the joint phase's own
    snapshot is returned and checkpointed."""
    triplets, cam = triplets_and_cam
    cfg = _cfg(separate_train_epoch=3, eval_fraction=0.34)
    ckpt = os.path.join(tmp_path, "ckpt.npz")
    state, history = train.train(triplets, cam, DEPTH, FEAT, DISC, cfg, num_epochs=4,
                                  checkpoint_path=ckpt, plateau_patience=1,
                                  plateau_min_rel_improve=0.99, device="cpu")
    assert [(h["epoch"], h["joint"]) for h in history] == [(0, False), (1, False), (3, True)]
    assert [bool(h.get("snapshotted")) for h in history] == [True, False, True]
    # the joint epoch started from the epoch-0 snapshot: 2 + 2 steps
    assert state.step == 4 and state.epoch == 4
    restored = train.load_checkpoint(ckpt, state)
    for (_, a), (_, b) in zip(train.param_leaves(restored.params), train.param_leaves(state.params)):
        assert torch.equal(a.detach(), b.detach())


def test_time_budget_stops_at_the_first_epoch_boundary(triplets_and_cam):
    triplets, cam = triplets_and_cam
    state, history = train.train(triplets, cam, DEPTH, FEAT, DISC, _cfg(eval_fraction=0.34),
                                 num_epochs=3, time_budget_s=1e-6, device="cpu")
    assert len(history) == 1 and state.epoch == 1
