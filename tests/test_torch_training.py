"""The port's training losses, discriminator, resize, datasets, export and
checkpoints against the JAX package (sage_slam_tpu/training/).

Inputs are made with numpy from a seed and go through both packages. The
dataset pipeline is host numpy in both, so its triplets must be equal bit
for bit, on the cv2 branch and on the numpy fallback (``_HAS_CV2``
monkeypatched in both modules). Tolerances are stated per test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sage_slam_tpu.io.dataset import Bowl3DInterface as JBowl3D
from sage_slam_tpu.models import depth_network as jdepth
from sage_slam_tpu.models import feature_network as jfeat
from sage_slam_tpu.training import dataset as jds
from sage_slam_tpu.training import discriminator as jdisc
from sage_slam_tpu.training import export as jexport
from sage_slam_tpu.training import losses as jl
from sage_slam_tpu.training import train as jtrain
from sage_slam_tpu_torch import convert
from sage_slam_tpu_torch.models.depth_network import DepthNetConfig
from sage_slam_tpu_torch.models.feature_network import FeatureNetConfig
from sage_slam_tpu_torch.training import dataset as tds
from sage_slam_tpu_torch.training import discriminator, export, losses, train

torch.set_num_threads(1)


def _t(x):
    return torch.tensor(np.asarray(x))


def _close(a, b, rtol=1e-5, atol=1e-7):
    np.testing.assert_allclose(np.asarray(a.detach() if isinstance(a, torch.Tensor) else a),
                               np.asarray(b), rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# losses (float32; rtol 1e-5 unless stated)


def test_depth_and_decorrelation_losses_match_jax():
    rng = np.random.default_rng(0)
    gt = rng.uniform(0.5, 2, (2, 8, 10)).astype(np.float32)
    pred = rng.uniform(0.5, 2, (2, 8, 10)).astype(np.float32)
    mask = (rng.uniform(size=(2, 8, 10)) > 0.2).astype(np.float32)
    _close(losses.scale_invariant_depth_loss(_t(gt), _t(pred), _t(mask)),
           jl.scale_invariant_depth_loss(gt, pred, mask))
    basis = rng.standard_normal((2, 4, 16, 20)).astype(np.float32)
    bmask = (rng.uniform(size=(2, 1, 16, 20)) > 0.3).astype(np.float32)
    _close(losses.basis_decorrelation_loss(_t(basis), _t(bmask)),
           jl.basis_decorrelation_loss(basis, bmask))
    same = np.tile(rng.standard_normal((1, 1, 8, 10)), (1, 4, 1, 1)).astype(np.float32)
    assert abs(float(losses.basis_decorrelation_loss(_t(same), torch.ones(1, 1, 8, 10))) - 1.0) < 1e-4


def test_flow_and_histogram_losses_match_jax():
    """Values and gradients (the flow loss's normaliser is detached as JAX's
    stop_gradient): rtol 1e-5."""
    rng = np.random.default_rng(1)
    gt = rng.standard_normal((2, 2, 8, 10)).astype(np.float32) * 3
    pred = rng.standard_normal((2, 2, 8, 10)).astype(np.float32) * 3
    mask = (rng.uniform(size=(2, 1, 8, 10)) > 0.3).astype(np.float32)
    p = _t(pred).requires_grad_(True)
    val = losses.normalized_masked_l2_flow_loss(_t(gt), p, _t(mask))
    (g,) = torch.autograd.grad(val, p)
    jv, jg = jax.value_and_grad(lambda q: jl.normalized_masked_l2_flow_loss(gt, q, mask))(pred)
    _close(val, jv)
    _close(g, jg, atol=1e-8)
    cdfs = [rng.uniform(size=(32, 8)).astype(np.float32) for _ in range(3)]
    _close(losses.triplet_histogram_loss(*map(_t, cdfs)), jl.triplet_histogram_loss(*cdfs))
    desc = np.tanh(rng.standard_normal((40, 8))).astype(np.float32)
    _close(losses.descriptor_cdf_histogram(_t(desc)), jl.descriptor_cdf_histogram(desc), atol=1e-6)


def test_response_losses_match_jax():
    """rr_loss, no_match_loss and soft_matching_locations with a large
    sigma (the shift-invariant softmax must not underflow); values and the
    gradient with respect to sigma, rtol 1e-5 (1e-4 on the gradient)."""
    rng = np.random.default_rng(2)
    hw, c, w = 80, 8, 10
    d0 = rng.standard_normal((hw, c)).astype(np.float32)
    d1 = (d0 + 0.1 * rng.standard_normal((hw, c))).astype(np.float32)
    kp = np.array([3, 10, 50, 77])
    gt = np.array([3, 11, 50, 70])
    for sigma in (10.0, 300.0):
        s = torch.tensor(sigma, requires_grad=True)
        v = losses.rr_loss(_t(d0), _t(d1), _t(kp), _t(gt), s)
        (g,) = torch.autograd.grad(v, s)
        jv, jg = jax.value_and_grad(lambda q: jl.rr_loss(d0, d1, kp, gt, q))(jnp.float32(sigma))
        _close(v, jv)
        _close(g, jg, rtol=1e-4)
        _close(losses.no_match_loss(_t(d0), _t(d1), _t(kp), torch.tensor(sigma)),
               jl.no_match_loss(d0, d1, kp, sigma), atol=1e-9)
        _close(losses.soft_matching_locations(_t(d0), _t(d1), _t(kp), torch.tensor(sigma), w),
               jl.soft_matching_locations(d0, d1, kp, sigma, w), rtol=1e-5, atol=1e-5)
    good = float(losses.rr_loss(_t(d0), _t(d0), _t(kp), _t(kp), torch.tensor(10.0)))
    bad = float(losses.rr_loss(_t(d0), _t(d0), _t(kp), _t(gt[::-1].copy()), torch.tensor(10.0)))
    assert good < bad


# ---------------------------------------------------------------------------
# discriminator and resize


def test_discriminator_matches_jax_with_its_params():
    """JAX's discriminator params carried over by name
    (convert.disc_params_from_numpy): the validity scalar and the LSGAN
    losses, rtol 1e-4; the gradient of the d loss with respect to every
    parameter against jax.grad, 1e-3 of each gradient's max |value|."""
    cfg_j = jdisc.DiscConfig(img_height=16, img_width=20, num_blocks=2, filter_base=4)
    cfg_t = discriminator.DiscConfig(img_height=16, img_width=20, num_blocks=2, filter_base=4)
    params = jdisc.init_params(jax.random.key(3), cfg_j)
    net = convert.disc_params_from_numpy(jax.tree.map(np.asarray, params), cfg_t, "cpu")
    names = [n for n, _ in train.module_leaves(net)]
    assert names == sorted(jexport.flatten_params(params), key=train._path_key)
    rng = np.random.default_rng(4)
    real, fake = (rng.standard_normal((4, 16, 20)).astype(np.float32) for _ in range(2))

    def jloss(p):
        return jdisc.lsgan_d_loss(jdisc.apply(p, real, cfg_j), jdisc.apply(p, fake, cfg_j))

    jv, jg = jax.value_and_grad(jloss)(params)
    tv = discriminator.lsgan_d_loss(discriminator.apply(net, _t(real)), discriminator.apply(net, _t(fake)))
    _close(tv, jv, rtol=1e-4)
    _close(discriminator.lsgan_g_loss(discriminator.apply(net, _t(fake))),
           jdisc.lsgan_g_loss(jdisc.apply(params, fake, cfg_j)), rtol=1e-4)
    grads = torch.autograd.grad(tv, [p for _, p in train.module_leaves(net)])
    for name, g, r in zip(names, grads, jax.tree.flatten(jg)[0]):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-3, atol=1e-3 * float(np.abs(r).max()),
                                   err_msg=name)


def test_discriminator_init_is_seeded():
    """The port's init from a torch.Generator: same seed, same weights; the
    1x1 conv and the head N(0, 0.05^2), zero biases."""
    cfg = discriminator.DiscConfig()
    a = discriminator.init_network(torch.Generator().manual_seed(5), cfg)
    b = discriminator.init_network(torch.Generator().manual_seed(5), cfg)
    for (n, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(x, y), n
    assert a.adv.weight.shape == (4 * 5, 1) and float(a.adv.bias.detach().abs().max()) == 0.0
    assert 0.02 < float(a.adv.weight.detach().std()) < 0.09


@pytest.mark.parametrize("shape", [(3, 128, 160), (3, 32, 40)], ids=["make_eval", "small"])
def test_resize_matches_jax_image_resize(shape):
    """train.resize_linear at half size against jax.image.resize(...,
    "linear") (an antialiased triangle filter when downsampling): atol
    1e-6 on values in [0, 1]."""
    x = np.random.default_rng(6).random(shape).astype(np.float32)
    out = (shape[0], shape[1] // 2, shape[2] // 2)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), out, "linear"))
    np.testing.assert_allclose(train.resize_linear(_t(x), out[1:]).numpy(), ref, atol=1e-6)


# ---------------------------------------------------------------------------
# datasets: bit-equal triplets on both branches


@pytest.fixture(params=[True, False], ids=["cv2", "numpy-fallback"])
def cv2_branch(request, monkeypatch):
    if request.param:
        pytest.importorskip("cv2")
    monkeypatch.setattr(jds, "_HAS_CV2", request.param)
    monkeypatch.setattr(tds, "_HAS_CV2", request.param)
    return request.param


TRIPLET_FIELDS = ("image_src", "image_close", "image_far", "mask", "depth_src", "depth_close",
                  "rel_pose_close_src", "keypoints_src", "gt_match_close", "no_match_src",
                  "no_match_valid", "init_rel_pose", "init_overlap_ratio", "far_overlap_valid",
                  "rot_angles")


def _same_triplet(a, b):
    for f in TRIPLET_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=f)
    for f in ("fx", "fy", "cx", "cy", "width", "height"):
        assert getattr(a.camera, f) == getattr(b.camera, f), f


@pytest.fixture(scope="module")
def bowl_arrays():
    return JBowl3D(num_frames=24, height=32, width=40, seed=0, orbit_radius=0.16, rot_amp=0.15,
                   mask_margin=2).to_arrays()


@pytest.mark.parametrize("rot_aug", [True, False], ids=["rot-aug", "no-aug"])
def test_array_sequence_triplets_equal_jax(bowl_arrays, cv2_branch, rot_aug):
    cfg_kw = dict(num_keypoints=32, frame_interval=3, far_frame_interval=8, use_rotation_aug=rot_aug)
    j = jds.ArraySequenceDataset(bowl_arrays, cfg=jds.TripletConfig(**cfg_kw), out_hw=(16, 20),
                                 in_hw=(32, 40), seed=1)
    t = tds.ArraySequenceDataset(bowl_arrays, cfg=tds.TripletConfig(**cfg_kw), out_hw=(16, 20),
                                 in_hw=(32, 40), seed=1)
    for _ in range(3):
        _same_triplet(t.sample(), j.sample())


def test_npz_and_hdf5_triplets_equal_jax(bowl_arrays, cv2_branch, tmp_path):
    """NpzSequenceDataset over an .npz file and FusionHDF5Dataset over a
    bag_<id>/fusion_data.hdf5 tree (patient filter, sqrt sequence
    sampling) give JAX's triplets."""
    h5py = pytest.importorskip("h5py")
    path = tmp_path / "seq.npz"
    np.savez(path, **bowl_arrays)
    kw = dict(num_keypoints=24, cfg=None, out_hw=(16, 20), in_hw=(32, 40), seed=2, close_range=3,
              far_min=8)
    j = jds.NpzSequenceDataset(str(path), **kw)
    t = tds.NpzSequenceDataset(str(path), **kw)
    assert t.cfg == tds.TripletConfig(**{f: getattr(j.cfg, f) for f in j.cfg.__dataclass_fields__})
    _same_triplet(t.sample(), j.sample())
    n = bowl_arrays["color"].shape[0]
    k = bowl_arrays["intrinsics"]
    for bag, frames in ((1, n), (2, n - 6), (3, n - 3)):
        d = tmp_path / f"bag_{bag}"
        d.mkdir()
        with h5py.File(d / "fusion_data.hdf5", "w") as f:
            f["color"] = (255 * bowl_arrays["color"][:frames]).astype(np.uint8)
            f["mask"] = bowl_arrays["mask"][..., None]
            f["render_depth"] = bowl_arrays["depth"][:frames, ..., None]
            f["render_mask"] = (bowl_arrays["depth"][:frames, ..., None] > 0).astype(np.uint8)
            f["extrinsics"] = bowl_arrays["poses"][:frames]
            f["intrinsics"] = np.array([[k[0], 0, k[2]], [0, k[1], k[3]], [0, 0, 1]], np.float32)
    cfg_kw = dict(num_keypoints=24, frame_interval=3, far_frame_interval=6, use_rotation_aug=False)
    j = jds.FusionHDF5Dataset(str(tmp_path), patient_ids=[1, 3], out_hw=(16, 20), in_hw=(32, 40),
                              cfg=jds.TripletConfig(**cfg_kw), seed=3)
    t = tds.FusionHDF5Dataset(str(tmp_path), patient_ids=[1, 3], out_hw=(16, 20), in_hw=(32, 40),
                              cfg=tds.TripletConfig(**cfg_kw), seed=3)
    np.testing.assert_array_equal(t.probability, j.probability)
    assert len(t.files) == 2
    for _ in range(2):
        _same_triplet(t.sample(), j.sample())


def test_synthetic_triplets_and_helpers_equal_jax(cv2_branch):
    j, t = jds.SyntheticTripletDataset(16, 20, num_keypoints=16, seed=4), tds.SyntheticTripletDataset(
        16, 20, num_keypoints=16, seed=4)
    for _ in range(2):
        _same_triplet(t.sample(), j.sample())
    rng = np.random.default_rng(5)
    img = rng.random((3, 32, 40)).astype(np.float32)
    mask = np.ones((16, 20), np.float32)
    mask[:2] = 0
    np.testing.assert_array_equal(tds.fast_keypoints_1d(img, mask, (16, 20)),
                                  jds.fast_keypoints_1d(img, mask, (16, 20)))
    for a, b in zip(tds.rotation_augment(img, np.ones((32, 40), np.float32), 0.3),
                    jds.rotation_augment(img, np.ones((32, 40), np.float32), 0.3)):
        np.testing.assert_array_equal(a, b)
    rel = np.eye(4)
    rel[:3, 3] = [0.05, -0.02, 0.01]
    cfg = tds.TripletConfig()
    np.testing.assert_array_equal(tds.perturb_pose(rel, cfg, np.random.default_rng(6)),
                                  jds.perturb_pose(rel, jds.TripletConfig(), np.random.default_rng(6)))


# ---------------------------------------------------------------------------
# export and checkpoints, both directions

H, W, CS, FS = 16, 20, 4, 8


def _jax_cfgs():
    return (jdepth.DepthNetConfig(filter_list=(4, 8), bottleneck=8, bias_inner=(8, 1), basis_inner=((8, CS),)),
            jfeat.FeatureNetConfig(filter_list=(4, 8), bottleneck=8, desc_inner=(8, FS), map_inner=(8, FS)),
            jdisc.DiscConfig(img_height=H, img_width=W, num_blocks=2, filter_base=4))


def _port_cfgs():
    return (DepthNetConfig(filter_list=(4, 8), bottleneck=8, bias_inner=(8, 1), basis_inner=((8, CS),)),
            FeatureNetConfig(filter_list=(4, 8), bottleneck=8, desc_inner=(8, FS), map_inner=(8, FS)),
            discriminator.DiscConfig(img_height=H, img_width=W, num_blocks=2, filter_base=4))


@pytest.fixture(scope="module")
def jax_state():
    d, f, g = _jax_cfgs()
    state, _, _ = jtrain.init_state(jax.random.key(7), d, f, g, jtrain.TrainConfig(pyramid_levels=2))
    return state


def _port_state():
    d, f, g = _port_cfgs()
    return train.init_state(torch.Generator().manual_seed(8), d, f, g,
                            train.TrainConfig(pyramid_levels=2), device="cpu")


def test_jax_checkpoint_loads_into_the_port(jax_state, tmp_path):
    """A checkpoint JAX wrote loads into the port leaf for leaf (equal
    arrays), with its step and epoch."""
    path = str(tmp_path / "jax.npz")
    jtrain.save_checkpoint(path, jax_state._replace(step=jnp.asarray(5), epoch=3))
    restored = train.load_checkpoint(path, _port_state())
    assert (restored.step, restored.epoch) == (5, 3)
    for (name, t), j in zip(train.param_leaves(restored.params), jax.tree.flatten(jax_state.params)[0]):
        np.testing.assert_array_equal(t.detach().numpy(), np.asarray(j), err_msg=name)


def test_port_checkpoint_loads_into_jax(jax_state, tmp_path):
    """The port's checkpoint loads through JAX's load_checkpoint; a port
    round trip restores every parameter and leaves the given state alone."""
    state = _port_state()
    with torch.no_grad():
        state.params["log_sigma"].add_(0.25)
    path = str(tmp_path / "port.npz")
    train.save_checkpoint(path, state._replace(step=9, epoch=4))
    jr = jtrain.load_checkpoint(path, jax_state)
    assert (int(jr.step), jr.epoch) == (9, 4)
    for (name, t), j in zip(train.param_leaves(state.params), jax.tree.flatten(jr.params)[0]):
        np.testing.assert_array_equal(np.asarray(j), t.detach().numpy(), err_msg=name)
    other = _port_state()
    back = train.load_checkpoint(path, other)
    for (_, a), (_, b) in zip(train.param_leaves(back.params), train.param_leaves(state.params)):
        assert torch.equal(a.detach(), b.detach())
    assert not torch.equal(other.params["log_sigma"].detach(), back.params["log_sigma"].detach())


def test_export_roundtrip_both_packages(jax_state, tmp_path):
    """export_networks writes JAX's keys and _netcfg.json: the port's export
    loads into JAX's networks (and back into the port's) with outputs equal
    bit for bit (JAX's own outputs to float32 roundoff); JAX's export loads into the port's loaders; the BA weights
    round-trip through load_ba_params."""
    from sage_slam_tpu.models.partial_unet import load_torch_state_dict as j_load
    from sage_slam_tpu_torch.models import depth_network
    from sage_slam_tpu_torch.models.partial_unet import load_torch_state_dict

    d_cfg, f_cfg, _ = _port_cfgs()
    state = _port_state()
    paths = export.export_networks(state, str(tmp_path / "port"), d_cfg, f_cfg)
    jpaths = jexport.export_networks(jax_state, str(tmp_path / "jax"), *_jax_cfgs()[:2])
    assert set(paths) == set(jpaths) == {"depth", "feat", "disc", "ba", "netcfg"}
    for name in ("depth", "feat", "disc", "ba"):
        assert sorted(np.load(paths[name]).files) == sorted(np.load(jpaths[name]).files), name
    assert export.load_net_configs(paths["netcfg"]) == export.load_net_configs(jpaths["netcfg"])
    jd_cfg = jexport.load_net_configs(paths["netcfg"])[0]

    img = np.random.default_rng(9).random((3, 2 * H, 2 * W)).astype(np.float32)
    jnet = j_load(jdepth.init_params(jax.random.key(99), jd_cfg), dict(np.load(paths["depth"])))
    jb, jj = jdepth.apply(jnet, jnp.asarray(img), jnp.ones((1, 2 * H, 2 * W)), jd_cfg)
    with torch.no_grad():
        tb, tj = depth_network.apply(state.params["depth"], _t(img), torch.ones(1, 2 * H, 2 * W))
        fresh = load_torch_state_dict(depth_network.init_network(torch.Generator().manual_seed(1), d_cfg),
                                      dict(np.load(paths["depth"])))
        fb, fj = depth_network.apply(fresh, _t(img), torch.ones(1, 2 * H, 2 * W))
    assert torch.equal(fb, tb) and torch.equal(fj, tj)
    # float32 roundoff of two convolution stacks: rtol 1e-4, atol 1e-5
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tj.numpy(), np.asarray(jj), rtol=1e-4, atol=1e-5)

    net = load_torch_state_dict(depth_network.init_network(torch.Generator().manual_seed(2), d_cfg),
                                dict(np.load(jpaths["depth"])))
    for name, p in net.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), np.load(jpaths["depth"])[name])
    ba = export.load_ba_params(paths["ba"], device="cpu")
    for a, b in zip(ba, state.params["ba"]):
        assert torch.equal(a, b.detach())
    jba = export.load_ba_params(jpaths["ba"], device="cpu")
    for name in jba._fields:
        assert float(getattr(jba, name)) == float(getattr(jax_state.params["ba"], name))


def test_ba_loaders_refuse_a_silent_cpu_fallback(tmp_path):
    """Without CUDA, the BA parameters' constructor and loaders default to
    the card and raise; with device='cpu' they load."""
    from sage_slam_tpu_torch.training import diff_ba

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal needs its absence")
    npz = tmp_path / "x_ba.npz"
    np.savez(npz, **{n: np.float32(i) for i, n in enumerate(diff_ba.BAParams._fields)})
    pt = tmp_path / "ba_model.pt"
    torch.save({"model": {"photo_weight": torch.tensor(0.5)}}, pt)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        diff_ba.BAParams.init()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        diff_ba.load_ba_model(str(pt))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        export.load_ba_params(str(npz))
    assert float(diff_ba.load_ba_model(str(pt), device="cpu").photo_weight) == 0.5
    ba = export.load_ba_params(str(npz), device="cpu")
    assert [float(v) for v in ba] == list(range(len(diff_ba.BAParams._fields)))
    assert all(v.device.type == "cpu" for v in diff_ba.BAParams.init(device="cpu"))


def test_cyclic_lr_matches_jax():
    """The schedule in float32, bit for bit with JAX's, over two cycles."""
    cfg = train.TrainConfig(cycle_steps=7)
    jsched = jtrain.cyclic_lr(jtrain.TrainConfig(cycle_steps=7))
    sched = train.cyclic_lr(cfg)
    for step in range(30):
        assert np.float32(sched(step)) == np.float32(jsched(jnp.asarray(step))), step
