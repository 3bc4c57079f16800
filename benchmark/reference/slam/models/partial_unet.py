"""Partial-convolution U-Net primitives (port of
sage_slam_tpu/models/partial_unet.py).

Mask-aware convolutions renormalize by the local mask coverage and
propagate a binarized mask:

  update = conv(mask, ones3x3)/9;  binary = update >= 0.01
  out = (conv(x*mask, W) / (update + 1e-8) + b) * binary

The convolution runs WITHOUT its bias and the bias is added after the
renormalization, as in the JAX package (not added and subtracted again).

Blocks: down_conv (conv-GN-relu, conv-relu, maxpool2), up_conv
(nearest-up2, concat[dec, enc], conv-GN-relu, conv-relu), block
(conv-GN-relu, conv-activation). Every function takes one image [C, H, W]
and a mask [1, H, W]. GroupNorm groups = out_channels // group_size, eps
1e-5.

Parameters live in ``TwoConvBlock`` modules whose names follow the JAX
package's param tree (``conv1.weight``, ``bn.bias``, ...), so a JAX tree
or the reference's torch state_dict loads by name
(convert.depth_params_from_numpy). The convolutions are float32
(device.set_f32_precision switches cuDNN's TF32 off on the card).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [C, H, W], w [O, I, 3, 3] -> [O, H, W] (padding 1, no bias)."""
    return F.conv2d(x[None], w, padding=1)[0]


def partial_conv(conv: "Conv", x: torch.Tensor, mask: torch.Tensor):
    """PartialConv2d forward -> (out [O, H, W], binary mask [1, H, W])."""
    ones = torch.ones((1, 1, 3, 3), dtype=x.dtype, device=x.device)
    update = conv3x3(mask, ones) / 9.0
    binary = (update >= 0.01).to(x.dtype)
    raw = conv3x3(x * mask, conv.weight)
    out = (raw / (update + 1.0e-8) + conv.bias[:, None, None]) * binary
    return out, binary


def group_norm(norm: "Norm", x: torch.Tensor, num_groups: int, eps: float = 1e-5):
    """GroupNorm over [C, H, W] with per-channel affine (biased variance)."""
    return F.group_norm(x[None], num_groups, norm.weight, norm.bias, eps)[0]


def max_pool2(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Max pool kernel = stride = factor on [C, H, W]; odd sizes floor."""
    return F.max_pool2d(x[None], factor, factor)[0]


def upsample_nearest2(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def activation(x: torch.Tensor, name: str, eps: float = 1e-8) -> torch.Tensor:
    name = name.lower()
    if name == "relu":
        return torch.relu(x)
    if name == "tanh":
        return torch.tanh(x)
    if name == "linear":
        return x
    if name == "abs":
        return torch.abs(x)
    if name == "sigmoid":
        return torch.sigmoid(x)
    if name == "normalize":
        return (x + eps) / torch.linalg.vector_norm(x + eps, dim=0, keepdim=True)
    raise ValueError(f"unknown activation {name}")


class Conv(nn.Module):
    """A 3x3 convolution's parameters: weight [O, I, 3, 3], bias [O]."""

    def __init__(self, in_c: int, out_c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_c, in_c, 3, 3))
        self.bias = nn.Parameter(torch.zeros(out_c))


class Norm(nn.Module):
    """GroupNorm affine parameters: weight [C] (ones), bias [C] (zeros)."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))


class TwoConvBlock(nn.Module):
    """conv1, bn, conv2 of one down / up / plain block."""

    def __init__(self, in_c: int, out_c: int):
        super().__init__()
        self.conv1 = Conv(in_c, out_c)
        self.bn = Norm(out_c)
        self.conv2 = Conv(out_c, out_c)

    @property
    def out_channels(self) -> int:
        return self.conv1.weight.shape[0]

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Kaiming-uniform init like torch's Conv2d default with a relu gain
        (partial_unet._init_conv), GroupNorm affine at identity."""
        with torch.no_grad():
            for conv in (self.conv1, self.conv2):
                fan_in = conv.weight.shape[1] * 9
                bound = math.sqrt(1.0 / fan_in)
                gain = math.sqrt(2.0)
                w = torch.rand(conv.weight.shape, generator=generator)
                conv.weight.copy_((2.0 * w - 1.0) * (gain * bound))
                b = torch.rand(conv.bias.shape, generator=generator)
                conv.bias.copy_((2.0 * b - 1.0) * bound)
            self.bn.weight.fill_(1.0)
            self.bn.bias.zero_()


def _conv_gn_relu(p: TwoConvBlock, x, mask, group_size):
    x, mask = partial_conv(p.conv1, x, mask)
    x = torch.relu(group_norm(p.bn, x, max(1, p.out_channels // group_size)))
    return partial_conv(p.conv2, x, mask)


def down_conv(p: TwoConvBlock, x, mask, group_size=4, pooling=True, pool_factor=2):
    """PartialDownConv -> (pooled_x, pre_pool_x, pooled_mask)."""
    x, mask = _conv_gn_relu(p, x, mask, group_size)
    x = torch.relu(x)
    pre_pool = x
    if pooling:
        mask = max_pool2(mask, pool_factor)
        x = max_pool2(x, pool_factor)
    return x, pre_pool, mask


def block(p: TwoConvBlock, x, mask, out_activation, group_size=4):
    """PartialBlock -> (x, mask)."""
    x, mask = _conv_gn_relu(p, x, mask, group_size)
    return activation(x, out_activation), mask


def up_conv(p: TwoConvBlock, enc_out, dec_out, mask, group_size=4):
    """PartialUpConv, concat order [dec, enc]. An upsample that undershoots
    an odd encoder size is edge-padded to it."""
    dec_up = upsample_nearest2(dec_out)
    eh, ew = enc_out.shape[1:]
    dh, dw = dec_up.shape[1:]
    if (dh, dw) != (eh, ew):
        dec_up = F.pad(dec_up[None], (0, ew - dw, 0, eh - dh), mode="replicate")[0]
    x = torch.cat([dec_up, enc_out], dim=0)
    x, mask = _conv_gn_relu(p, x, mask, group_size)
    return torch.relu(x), mask


def blocks(channels) -> nn.ModuleList:
    """TwoConvBlocks chaining channels[i] -> channels[i + 1]."""
    return nn.ModuleList(
        TwoConvBlock(channels[i], channels[i + 1]) for i in range(len(channels) - 1)
    )


class UNetTrunk(nn.Module):
    """Encoder/decoder trunk shared by the depth and feature networks
    (depth_network._unet_trunk): pre_down_convs, down_convs, bottle_neck,
    up_convs."""

    def __init__(self, cfg):
        super().__init__()
        pre_filters = list(cfg.filter_list[: cfg.num_pre_steps])
        inner_filters = list(cfg.filter_list[cfg.num_pre_steps :])
        enc_pre = [cfg.in_channels] + pre_filters
        enc = [enc_pre[-1]] + inner_filters
        dec = [cfg.bottleneck] + list(reversed(inner_filters))
        self.cfg = cfg
        self.pre_down_convs = blocks(enc_pre)
        self.down_convs = blocks(enc)
        self.bottle_neck = TwoConvBlock(enc[-1], cfg.bottleneck)
        self.up_convs = nn.ModuleList(
            TwoConvBlock(dec[i] + enc[-i - 1], dec[i + 1]) for i in range(len(dec) - 1)
        )
        self.out_channels = dec[-1]

    def trunk(self, x, mask):
        """-> (decoder output, mask after the pre-down steps)."""
        gs = self.cfg.group_size
        for p in self.pre_down_convs:
            x, _, mask = down_conv(p, x, mask, gs)
        encoder_outs = []
        encoder_masks = []
        for p in self.down_convs:
            encoder_masks.append(mask)
            x, pre_pool, mask = down_conv(p, x, mask, gs)
            encoder_outs.append(pre_pool)
        x, mask = block(self.bottle_neck, x, mask, "relu", gs)
        for i, p in enumerate(self.up_convs):
            x, mask = up_conv(p, encoder_outs[-(i + 1)], x, encoder_masks[-(i + 1)], gs)
        return x, encoder_masks[0]

    def blocks_in_init_order(self):
        """The trunk's blocks in the order the JAX init draws their keys."""
        return [*self.pre_down_convs, *self.down_convs, self.bottle_neck, *self.up_convs]


def head(p_list, x, mask, out_activation, group_size):
    """A chain of blocks, relu between and ``out_activation`` on the last."""
    for i, p in enumerate(p_list):
        act = out_activation if i == len(p_list) - 1 else "relu"
        x, mask = block(p, x, mask, act, group_size)
    return x, mask


def load_torch_state_dict(net: nn.Module, state_dict, prefix: str = "") -> nn.Module:
    """Copy a state_dict (name -> array or tensor) into ``net``'s parameters,
    in place, and return ``net``. Names are the parameter names, under
    ``prefix.`` when a prefix is given. As in the JAX package's loader, only
    the names present are copied, each cast to its parameter's dtype; a
    parameter whose name is absent keeps its current (seeded init) value,
    and names that match no parameter are ignored. A shape that differs
    from its parameter's raises."""
    with torch.no_grad():
        for name, param in net.named_parameters():
            key = f"{prefix}.{name}" if prefix else name
            if key not in state_dict:
                continue
            value = torch.as_tensor(np.asarray(state_dict[key]))
            if tuple(value.shape) != tuple(param.shape):
                raise ValueError(f"{key}: shape {tuple(value.shape)} != parameter {tuple(param.shape)}")
            param.copy_(value.to(param.dtype))
    return net
