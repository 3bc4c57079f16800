"""Port parity of the frame-build networks: the partial-conv primitives,
the depth and feature U-Nets in all three feature modes, and the weight
carry from the JAX param tree (CPU, same numpy inputs through both)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sage_slam_tpu.models import depth_network as jdn
from sage_slam_tpu.models import feature_network as jfn
from sage_slam_tpu.models import partial_unet as jpu
from sage_slam_tpu_torch import convert
from sage_slam_tpu_torch.models import depth_network as tdn
from sage_slam_tpu_torch.models import feature_network as tfn
from sage_slam_tpu_torch.models import partial_unet as tpu

torch.set_num_threads(1)

NARROW_DEPTH = dict(filter_list=(4, 8), bottleneck=8, bias_inner=(8, 1), basis_inner=((8, 4),))
NARROW_FEAT = dict(filter_list=(4, 8), bottleneck=8, desc_inner=(8, 8), map_inner=(8, 8))


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32).copy())


def _conv(rng, c_in, c_out):
    conv = tpu.Conv(c_in, c_out)
    w = (rng.standard_normal((c_out, c_in, 3, 3)) * 0.1).astype(np.float32)
    b = rng.standard_normal(c_out).astype(np.float32)
    with torch.no_grad():
        conv.weight.copy_(_t(w))
        conv.bias.copy_(_t(b))
    return conv, {"weight": jnp.asarray(w), "bias": jnp.asarray(b)}


def _image_and_mask(rng, c, h, w, border=2):
    img = rng.random((c, h, w)).astype(np.float32)
    mask = np.zeros((1, h, w), np.float32)
    mask[:, border:h - border, border:w - border] = 1.0
    mask[:, : h // 3, : w // 4] = 0.0  # a partial-coverage corner
    return img, mask


def test_partial_conv_matches_jax():
    """Bias after the renormalization, as in JAX; masked pixels exactly 0.
    Tolerance: float32 conv roundoff amplified by 1/(update + 1e-8) <= 9."""
    rng = np.random.default_rng(0)
    conv, jp = _conv(rng, 3, 8)
    x = rng.standard_normal((3, 16, 20)).astype(np.float32)
    mask = (rng.uniform(size=(1, 16, 20)) > 0.3).astype(np.float32)
    out_j, m_j = jpu.partial_conv(jp, jnp.asarray(x), jnp.asarray(mask))
    out_t, m_t = tpu.partial_conv(conv, _t(x), _t(mask))
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), rtol=1e-5, atol=1e-5)
    assert np.all(out_t.detach().numpy()[:, m_t.numpy()[0] == 0] == 0.0)


def test_group_norm_pool_upsample_activations_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((16, 8, 10)).astype(np.float32)
    norm = tpu.Norm(16)
    w = rng.standard_normal(16).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    with torch.no_grad():
        norm.weight.copy_(_t(w))
        norm.bias.copy_(_t(b))
    ours = tpu.group_norm(norm, _t(x), 4).detach().numpy()
    ref = jpu.group_norm({"weight": jnp.asarray(w), "bias": jnp.asarray(b)}, jnp.asarray(x), 4)
    np.testing.assert_allclose(ours, np.asarray(ref), rtol=1e-5, atol=1e-5)
    # pool floors odd sizes; upsample repeats; both exact
    odd = rng.standard_normal((4, 7, 9)).astype(np.float32)
    np.testing.assert_array_equal(tpu.max_pool2(_t(odd)).numpy(), np.asarray(jpu.max_pool2(jnp.asarray(odd))))
    np.testing.assert_array_equal(
        tpu.upsample_nearest2(_t(odd)).numpy(), np.asarray(jpu.upsample_nearest2(jnp.asarray(odd)))
    )
    for name in ("relu", "tanh", "linear", "abs", "sigmoid", "normalize"):
        np.testing.assert_allclose(
            tpu.activation(_t(x), name).numpy(), np.asarray(jpu._activation(jnp.asarray(x), name)),
            rtol=1e-6, atol=1e-6, err_msg=name,
        )
    with pytest.raises(ValueError):
        tpu.activation(_t(x), "gelu")


def _block(rng, c_in, c_out):
    blk = tpu.TwoConvBlock(c_in, c_out)
    params = {}
    for name in ("conv1", "conv2"):
        conv, jp = _conv(rng, c_in if name == "conv1" else c_out, c_out)
        getattr(blk, name).load_state_dict(conv.state_dict())
        params[name] = jp
    params["bn"] = {"weight": jnp.ones(c_out), "bias": jnp.zeros(c_out)}
    return blk, params


def test_down_and_up_conv_at_an_odd_size_match_jax():
    """9x11 encoder: pooling floors to 4x5, the 2x upsample undershoots to
    8x10 and is edge-padded back to 9x11 (replicate pad)."""
    rng = np.random.default_rng(2)
    img, mask = _image_and_mask(rng, 3, 9, 11, border=1)
    down, jdown = _block(rng, 3, 4)
    up, jup = _block(rng, 4 + 3, 4)
    x_t, pre_t, m_t = tpu.down_conv(down, _t(img), _t(mask))
    x_j, pre_j, m_j = jpu.down_conv(jdown, jnp.asarray(img), jnp.asarray(mask))
    assert x_t.shape == (4, 4, 5)
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    np.testing.assert_allclose(x_t.detach().numpy(), np.asarray(x_j), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(pre_t.detach().numpy(), np.asarray(pre_j), rtol=1e-4, atol=1e-5)
    out_t, um_t = tpu.up_conv(up, _t(img), x_t, _t(mask))
    out_j, um_j = jpu.up_conv(jup, jnp.asarray(img), x_j, jnp.asarray(mask))
    assert out_t.shape == (4, 9, 11)
    np.testing.assert_array_equal(um_t.numpy(), np.asarray(um_j))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), rtol=1e-4, atol=1e-5)


def _max_rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _depth_pair(cfg_kwargs, seed):
    jcfg = jdn.DepthNetConfig(**cfg_kwargs)
    params = jdn.init_params(jax.random.key(seed), jcfg)
    net = convert.depth_params_from_numpy(
        jax.tree.map(np.asarray, params), tdn.DepthNetConfig(**cfg_kwargs), device="cpu"
    )
    return jcfg, params, net


@pytest.mark.parametrize("size", [(32, 40), (30, 38)], ids=["even", "odd-levels"])
def test_depth_network_narrow_matches_jax(size):
    """Narrow widths, bordered mask. Tolerance 2e-5 of the output's max
    |value|: float32 conv and group-norm roundoff through ~12 layers."""
    jcfg, params, net = _depth_pair(NARROW_DEPTH, 0)
    rng = np.random.default_rng(3)
    img, mask = _image_and_mask(rng, 3, *size)
    apply_j = jax.jit(lambda p, i, m: jdn.apply(p, i, m, jcfg))
    bias_j, basis_j = apply_j(params, jnp.asarray(img), jnp.asarray(mask))
    with torch.no_grad():
        bias_t, basis_t = tdn.apply(net, _t(img), _t(mask))
        bflat, jac = tdn.bias_and_jacobian(net, _t(img), _t(mask))
    assert bias_t.shape == bias_j.shape and basis_t.shape == basis_j.shape
    assert _max_rel(bias_t.numpy(), np.asarray(bias_j)) < 2e-5
    assert _max_rel(basis_t.numpy(), np.asarray(basis_j)) < 2e-5
    # bias_and_jacobian is apply's outputs flattened, as in JAX
    np.testing.assert_array_equal(jac.numpy(), basis_t.reshape(basis_t.shape[0], -1).T.numpy())
    assert bflat.shape == (bias_j.size,)
    # constant_depth_params pins the output and leaves the source net alone
    const = tdn.constant_depth_params(net, 2.0, 0.01)
    with torch.no_grad():
        cb, cbasis = tdn.apply(const, _t(img), _t(mask))
        again, _ = tdn.apply(net, _t(img), _t(mask))
    jb, jbasis = apply_j(jdn.constant_depth_params(params, 2.0, 0.01),
                         jnp.asarray(img), jnp.asarray(mask))
    np.testing.assert_allclose(cb.numpy(), np.asarray(jb), atol=1e-6)
    np.testing.assert_allclose(cbasis.numpy(), np.asarray(jbasis), atol=1e-6)
    np.testing.assert_array_equal(again.numpy(), bias_t.numpy())


def test_depth_network_full_width_matches_jax():
    """DepthNetConfig() at the published widths on a 128x160 image with a
    circular mask. Tolerance 1e-4 of the output's max |value| (five encoder
    levels, 128-channel convs)."""
    jcfg, params, net = _depth_pair({}, 5)
    assert sum(p.numel() for p in net.parameters()) == sum(
        np.asarray(x).size for x in jax.tree.leaves(params)
    )
    rng = np.random.default_rng(4)
    img = rng.random((3, 128, 160)).astype(np.float32)
    yy, xx = np.mgrid[:128, :160]
    mask = (((xx - 79.5) ** 2 + (yy - 63.5) ** 2) <= 73.0**2).astype(np.float32)[None]
    bias_j, basis_j = jdn.apply(params, jnp.asarray(img), jnp.asarray(mask), jcfg)
    with torch.no_grad():
        bias_t, basis_t = tdn.apply(net, _t(img), _t(mask))
    assert bias_t.shape == (1, 64, 80) and basis_t.shape == (16, 64, 80)
    assert _max_rel(bias_t.numpy(), np.asarray(bias_j)) < 1e-4
    assert _max_rel(basis_t.numpy(), np.asarray(basis_j)) < 1e-4


@pytest.mark.parametrize("mode", ["unet", "image", "handcrafted"])
def test_feature_network_modes_match_jax(mode):
    """All three modes, narrow widths, 32x40, bordered mask; the fixed
    modes must agree to float32 roundoff (atol 1e-5), the U-Net to 2e-5 of
    the output's max |value|."""
    kw = dict(NARROW_FEAT, mode=mode)
    jcfg = jfn.FeatureNetConfig(**kw)
    params = jfn.init_params(jax.random.key(1), jcfg)
    net = convert.feature_params_from_numpy(
        jax.tree.map(np.asarray, params), tfn.FeatureNetConfig(**kw), device="cpu"
    )
    rng = np.random.default_rng(5)
    img, mask = _image_and_mask(rng, 3, 32, 40)
    fmap_j, desc_j = jax.jit(lambda p, i, m: jfn.apply(p, i, m, jcfg))(
        params, jnp.asarray(img), jnp.asarray(mask))
    with torch.no_grad():
        fmap_t, desc_t = net(_t(img), _t(mask))
    assert fmap_t.shape == fmap_j.shape == (8, 16, 20)
    if mode == "unet":
        assert _max_rel(fmap_t.numpy(), np.asarray(fmap_j)) < 2e-5
        assert _max_rel(desc_t.numpy(), np.asarray(desc_j)) < 2e-5
    else:
        np.testing.assert_allclose(fmap_t.numpy(), np.asarray(fmap_j), atol=1e-5)
        assert desc_t is fmap_t


def test_init_from_a_generator_is_reproducible_and_named_like_jax():
    """Kaiming-uniform init from an explicit torch.Generator; parameter
    names are the JAX tree's paths; the bias head starts at +1."""
    cfg = tdn.DepthNetConfig(**NARROW_DEPTH)
    a = tdn.init_network(torch.Generator().manual_seed(7), cfg)
    b = tdn.init_network(torch.Generator().manual_seed(7), cfg)
    for (na, pa), (nb, pb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert na == nb and torch.equal(pa, pb)
    jnames = set(convert._flatten_params(
        jax.tree.map(np.asarray, jdn.init_params(jax.random.key(0), jdn.DepthNetConfig(**NARROW_DEPTH)))
    ))
    assert set(a.state_dict()) == jnames
    assert "dpt_basis_convs_hierarchy.basis_0.1.conv2.bias" in jnames
    w = a.pre_down_convs[0].conv1.weight
    assert float(w.detach().abs().max()) <= np.sqrt(2.0 / 27.0)
    assert float(a.dpt_bias_convs[-1].conv2.bias.detach().min()) > 1.0 - np.sqrt(1.0 / 72.0)
    f = tfn.init_network(torch.Generator().manual_seed(7), tfn.FeatureNetConfig(**NARROW_FEAT))
    fnames = set(convert._flatten_params(
        jax.tree.map(np.asarray, jfn.init_params(jax.random.key(0), jfn.FeatureNetConfig(**NARROW_FEAT)))
    ))
    assert set(f.state_dict()) == fnames
