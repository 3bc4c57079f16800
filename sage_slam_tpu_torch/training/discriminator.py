"""Adversarial depth-prior discriminator (port of
sage_slam_tpu/training/discriminator.py).

A conv net over (image, depth) pairs: DownBlock (conv-GN-relu, conv-relu,
maxpool2) and Block pairs, a 1x1 conv and a linear validity head, trained
with the LSGAN objective. Parameter names follow the JAX param tree
(``blocks.0.conv1.weight``, ``final_conv.weight``, ``adv.weight``, ...).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ..models import partial_unet as pu


class DiscConfig(NamedTuple):
    in_channels: int = 4  # rgb + depth
    filter_base: int = 12
    num_blocks: int = 4
    group_size: int = 4
    img_height: int = 64
    img_width: int = 80


class Linear(nn.Module):
    """A weight [I, O] and a bias [O] (the JAX tree's layout)."""

    def __init__(self, weight_shape, bias_size: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(weight_shape))
        self.bias = nn.Parameter(torch.zeros(bias_size))


class Discriminator(nn.Module):
    def __init__(self, cfg: DiscConfig = DiscConfig()):
        super().__init__()
        self.cfg = cfg
        chans = [(cfg.in_channels, cfg.filter_base), (cfg.filter_base, cfg.filter_base)]
        for i in range(cfg.num_blocks - 1):
            c = cfg.filter_base * 2**i
            chans += [(c, c * 2), (c * 2, c * 2)]
        self.blocks = nn.ModuleList(pu.TwoConvBlock(cin, cout) for cin, cout in chans)
        c_last = cfg.filter_base * 2 ** (cfg.num_blocks - 1)
        h = cfg.img_height // 2**cfg.num_blocks
        w = cfg.img_width // 2**cfg.num_blocks
        self.final_conv = Linear((1, c_last, 1, 1), 1)
        self.adv = Linear((h * w, 1), 1)

    def reset_parameters(self, generator: torch.Generator):
        """Random init from ``generator``: the blocks as the U-Nets', the
        1x1 conv and the head N(0, 0.05^2), zero biases."""
        for p in self.blocks:
            p.reset_parameters(generator)
        with torch.no_grad():
            for lin in (self.final_conv, self.adv):
                lin.weight.copy_(torch.randn(lin.weight.shape, generator=generator) * 0.05)
                lin.bias.zero_()
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply(self, x)


def init_network(generator: torch.Generator, cfg: DiscConfig = DiscConfig(), device=None):
    net = Discriminator(cfg).reset_parameters(generator)
    return net.to(device) if device is not None else net


def _plain_conv(p: pu.Conv, x: torch.Tensor) -> torch.Tensor:
    return F.conv2d(x[None], p.weight, p.bias, padding=1)[0]


def apply(net: Discriminator, x: torch.Tensor) -> torch.Tensor:
    """x [C, H, W] -> validity scalar."""
    gs = net.cfg.group_size
    for i, p in enumerate(net.blocks):
        g = max(1, p.out_channels // gs)
        x = torch.relu(pu.group_norm(p.bn, _plain_conv(p.conv1, x), g))
        x = torch.relu(_plain_conv(p.conv2, x))
        if i % 2 == 0:  # the DownBlocks are the even entries
            x = pu.max_pool2(x)
    fc = net.final_conv
    x = F.conv2d(x[None], fc.weight, fc.bias)[0]
    return x.reshape(-1) @ net.adv.weight[:, 0] + net.adv.bias[0]


def lsgan_d_loss(d_real, d_fake):
    """The discriminator's LSGAN objective."""
    return 0.5 * (torch.mean((d_real - 1.0) ** 2) + torch.mean(d_fake**2))


def lsgan_g_loss(d_fake):
    return torch.mean((d_fake - 1.0) ** 2)
