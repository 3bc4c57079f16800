"""FeatureNet: partial-conv U-Net producing photometric features and
matching descriptors (port of sage_slam_tpu/models/feature_network.py).

Same trunk as DepthNet; two heads: feat_map [16] (tanh) for the
photometric factor and feat_desc [16] (tanh) for matching. Two
parameter-free modes replace the U-Net: ``"image"`` (pooled, centred RGB)
and ``"handcrafted"`` (a fixed shift-equivariant filter bank).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

from . import partial_unet as pu


class FeatureNetConfig(NamedTuple):
    in_channels: int = 3
    num_pre_steps: int = 1
    filter_list: Sequence[int] = (8, 16, 32, 64, 128)
    bottleneck: int = 128
    desc_inner: Sequence[int] = (64, 64, 16)
    map_inner: Sequence[int] = (64, 64, 16)
    desc_out_activation: str = "tanh"
    map_out_activation: str = "tanh"
    group_size: int = 4
    mode: str = "unet"  # "unet" | "image" | "handcrafted"


class FeatureNetwork(pu.UNetTrunk):
    """The U-Net parameters exist in every mode, as in the JAX init."""

    def __init__(self, cfg: FeatureNetConfig = FeatureNetConfig()):
        super().__init__(cfg)
        self.feat_desc_convs = pu.blocks([self.out_channels, *cfg.desc_inner])
        self.feat_map_convs = pu.blocks([self.out_channels, *cfg.map_inner])

    def reset_parameters(self, generator: torch.Generator):
        for p in (*self.blocks_in_init_order(), *self.feat_desc_convs, *self.feat_map_convs):
            p.reset_parameters(generator)
        return self

    def forward(self, image: torch.Tensor, mask: torch.Tensor):
        return apply(self, image, mask)


def init_network(generator: torch.Generator, cfg: FeatureNetConfig = FeatureNetConfig(),
                 device=None) -> FeatureNetwork:
    net = FeatureNetwork(cfg).reset_parameters(generator)
    return net.to(device) if device is not None else net


def apply(net: FeatureNetwork, image: torch.Tensor, mask: torch.Tensor):
    """image [3, H, W], mask [1, H, W] -> (feat_map [C, h, w],
    feat_desc [C, h, w])."""
    cfg = net.cfg
    if cfg.mode == "handcrafted":
        fmap = handcrafted_apply(image, mask, cfg.map_inner[-1], cfg.num_pre_steps)
        return fmap, fmap
    if cfg.mode == "image":
        fmap = image_apply(image, mask, cfg.map_inner[-1], cfg.num_pre_steps)
        return fmap, fmap
    if cfg.mode != "unet":
        raise ValueError(f"unknown feature mode {cfg.mode!r}")
    x, mask0 = net.trunk(image, mask)
    gs = cfg.group_size
    desc, _ = pu.head(net.feat_desc_convs, x, mask0, cfg.desc_out_activation, gs)
    fmap, _ = pu.head(net.feat_map_convs, x, mask0, cfg.map_out_activation, gs)
    return fmap, desc


def _edge_pad(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Replicate one row (dim=1) or column (dim=2) on both sides of [C, H, W]."""
    pad = (0, 0, 1, 1) if dim == 1 else (1, 1, 0, 0)
    return F.pad(x[None], pad, mode="replicate")[0]


def _blur3(x: torch.Tensor) -> torch.Tensor:
    """Separable [1,2,1]/4 blur per channel, edge-replicate padding."""
    xp = _edge_pad(x, 1)
    x = 0.25 * xp[:, :-2] + 0.5 * xp[:, 1:-1] + 0.25 * xp[:, 2:]
    xp = _edge_pad(x, 2)
    return 0.25 * xp[:, :, :-2] + 0.5 * xp[:, :, 1:-1] + 0.25 * xp[:, :, 2:]


def _pool_pre_steps(image, mask, num_pre_steps):
    x = image * mask
    for _ in range(num_pre_steps):
        x = 0.25 * (x[:, 0::2, 0::2] + x[:, 1::2, 0::2] + x[:, 0::2, 1::2] + x[:, 1::2, 1::2])
    return x


def _fill_channels(feats, num_channels):
    while feats.shape[0] < num_channels:
        feats = torch.cat([feats, _blur3(feats)], dim=0)
    return feats[:num_channels]


def image_apply(image, mask, num_channels: int, num_pre_steps: int = 1):
    """Raw-intensity features: pooled RGB, zero-centred; channels beyond RGB
    repeat with a 1-px blur."""
    feats = 2.0 * _pool_pre_steps(image, mask, num_pre_steps) - 1.0
    step = 2**num_pre_steps
    return _fill_channels(feats, num_channels) * mask[:, ::step, ::step]


def handcrafted_apply(image, mask, num_channels: int, num_pre_steps: int = 1):
    """Fixed translation-equivariant bank -> [C, h, w]: band-passes of
    luminance, opponent colours and x/y gradients of blurred maps, tanh-
    bounded; channels repeat with growing blur past the bank."""
    x = _pool_pre_steps(image, mask, num_pre_steps)
    lum = torch.mean(x, dim=0, keepdim=True)
    rg = (x[0:1] - x[1:2]) if x.shape[0] >= 2 else lum
    by = (x[2:3] - lum) if x.shape[0] >= 3 else lum

    def blur_n(t, n):
        for _ in range(n):
            t = _blur3(t)
        return t

    b1, b2, b4, b8 = (blur_n(lum, n) for n in (1, 2, 4, 8))
    rg2, rg8 = blur_n(rg, 2), blur_n(rg, 8)
    by2, by8 = blur_n(by, 2), blur_n(by, 8)

    def grad_xy(t):
        gx = _edge_pad(t, 2)
        gy = _edge_pad(t, 1)
        return 0.5 * (gx[:, :, 2:] - gx[:, :, :-2]), 0.5 * (gy[:, 2:] - gy[:, :-2])

    g2x, g2y = grad_xy(b2)
    g8x, g8y = grad_xy(b8)
    feats = torch.cat([b1 - b4, b2 - b8, rg2 - rg8, by2 - by8, g2x, g2y, g8x, g8y], dim=0)
    step = 2**num_pre_steps
    return torch.tanh(4.0 * _fill_channels(feats, num_channels)) * mask[:, ::step, ::step]
