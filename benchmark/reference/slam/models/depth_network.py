"""DepthNet: partial-conv U-Net producing a depth bias and a code basis
(port of sage_slam_tpu/models/depth_network.py).

Published widths (eval_artifacts/net_netcfg.json): in=3 channels, one
pre-down step, filters [8,16,32,64,128], bottleneck 128, bias head
[64,64,1] (linear), basis hierarchy [[128,128,16]] (linear), so a
128x160 image gives (bias [1,64,80], basis [16,64,80]). The basis IS the
code Jacobian of depth: depth = scale * (bias + basis . code).

Parameter names follow the JAX param tree (``pre_down_convs.0.conv1.weight``,
``dpt_basis_convs_hierarchy.basis_0.2.conv2.bias``, ...).
"""

from __future__ import annotations

import copy
from typing import NamedTuple, Sequence

import torch
from torch import nn

from . import partial_unet as pu


class DepthNetConfig(NamedTuple):
    in_channels: int = 3
    num_pre_steps: int = 1
    filter_list: Sequence[int] = (8, 16, 32, 64, 128)
    bottleneck: int = 128
    bias_inner: Sequence[int] = (64, 64, 1)
    basis_inner: Sequence[Sequence[int]] = ((128, 128, 16),)
    bias_out_activation: str = "linear"
    basis_out_activation: str = "linear"
    group_size: int = 4


class DepthNetwork(pu.UNetTrunk):
    def __init__(self, cfg: DepthNetConfig = DepthNetConfig()):
        super().__init__(cfg)
        self.dpt_bias_convs = pu.blocks([self.out_channels, *cfg.bias_inner])
        self.dpt_basis_convs_hierarchy = nn.ModuleDict(
            {
                f"basis_{bid}": pu.blocks([self.out_channels, *inner])
                for bid, inner in enumerate(cfg.basis_inner)
            }
        )

    def reset_parameters(self, generator: torch.Generator, bias_output_offset: float = 1.0):
        """Random init from ``generator``; the last bias-head conv's bias is
        offset so an untrained net emits depth around +offset
        (depth_network.init_params)."""
        order = [
            *self.blocks_in_init_order(),
            *self.dpt_bias_convs,
            *(p for key in self.dpt_basis_convs_hierarchy
              for p in self.dpt_basis_convs_hierarchy[key]),
        ]
        for p in order:
            p.reset_parameters(generator)
        with torch.no_grad():
            self.dpt_bias_convs[-1].conv2.bias.add_(bias_output_offset)
        return self

    def forward(self, image: torch.Tensor, mask: torch.Tensor):
        return apply(self, image, mask)


def init_network(generator: torch.Generator, cfg: DepthNetConfig = DepthNetConfig(),
                 bias_output_offset: float = 1.0, device=None) -> DepthNetwork:
    """A randomly initialised DepthNetwork (float32, on ``device``)."""
    net = DepthNetwork(cfg).reset_parameters(generator, bias_output_offset)
    return net.to(device) if device is not None else net


def apply(net: DepthNetwork, image: torch.Tensor, mask: torch.Tensor):
    """image [3, H, W], mask [1, H, W] -> (bias [1, h, w], basis [CS, h, w])
    with (h, w) = (H, W) / 2^num_pre_steps."""
    cfg = net.cfg
    gs = cfg.group_size
    x, mask0 = net.trunk(image, mask)
    basis_outs = []
    for key in sorted(net.dpt_basis_convs_hierarchy.keys()):
        convs = net.dpt_basis_convs_hierarchy[key]
        pool_factor = 2 ** int(key.split("_")[1])
        b, m = x, mask0
        for i, p in enumerate(convs):
            if i == 0:
                # PartialDownConvNoPre: conv-GN-relu, conv-relu, optional pool
                b, _, m = pu.down_conv(p, b, m, gs, pooling=pool_factor > 1,
                                       pool_factor=pool_factor)
            elif i == len(convs) - 1:
                b, m = pu.block(p, b, m, cfg.basis_out_activation, gs)
            else:
                b, m = pu.block(p, b, m, "relu", gs)
        basis_outs.append(b)
    bias, _ = pu.head(net.dpt_bias_convs, x, mask0, cfg.bias_out_activation, gs)
    return bias, torch.cat(basis_outs, dim=0)


def bias_and_jacobian(net: DepthNetwork, image, mask):
    """-> (bias_flat [hw], dpt_jac_code [hw, CS]), the runtime interface."""
    bias, basis = apply(net, image, mask)
    cs = basis.shape[0]
    return bias.reshape(-1), basis.reshape(cs, -1).T


def constant_depth_params(net: DepthNetwork, constant: float = 1.0,
                          basis_eps: float = 0.01) -> DepthNetwork:
    """A copy of ``net`` whose output is pinned to a constant bias map plus a
    tiny uniform basis: the final bias/basis head convs get zero weights and
    constant biases."""
    out = copy.deepcopy(net)
    with torch.no_grad():
        last = out.dpt_bias_convs[-1].conv2
        last.weight.zero_()
        last.bias.fill_(constant)
        for key in out.dpt_basis_convs_hierarchy:
            blast = out.dpt_basis_convs_hierarchy[key][-1].conv2
            blast.weight.zero_()
            blast.bias.fill_(basis_eps)
    return out
