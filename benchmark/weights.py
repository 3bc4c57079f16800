"""The networks' weights, made from the seed on the card.

The depth network's parameters are drawn as the program's own init draws
them (TwoConvBlock.reset_parameters: Kaiming-uniform convolutions with a
relu gain, biases uniform in +-1/sqrt(fan_in), GroupNorm at identity, and
the last bias-head convolution's bias offset by +1 so an untrained net
emits depth around 1), but in one ``torch.rand`` call on a card generator
seeded from ``--seed``. The same tensors are loaded into the program's
network and the reference's.
"""

from __future__ import annotations

import math

import torch

BIAS_OUTPUT = "dpt_bias_convs.{last}.conv2.bias"  # the offset bias (depth_network)


def depth_state(shapes: dict, seed: int, device, bias_output_offset: float = 1.0) -> dict:
    """{parameter name: tensor} for the named shapes (a DepthNetwork's
    ``named_parameters`` shapes), drawn from ``seed`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    drawn = [name for name in shapes if ".conv" in name]
    total = sum(math.prod(shapes[n]) for n in drawn)
    u = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0
    out, at = {}, 0
    fan_in = {}
    for name in drawn:
        if name.endswith(".weight"):
            fan_in[name.rsplit(".", 1)[0]] = shapes[name][1] * 9
    for name in drawn:
        size = math.prod(shapes[name])
        bound = math.sqrt(1.0 / fan_in[name.rsplit(".", 1)[0]])
        gain = math.sqrt(2.0) if name.endswith(".weight") else 1.0
        out[name] = (u[at:at + size] * (gain * bound)).reshape(shapes[name])
        at += size
    for name, shape in shapes.items():
        if name.endswith(".bn.weight"):
            out[name] = torch.ones(shape, device=device)
        elif name.endswith(".bn.bias"):
            out[name] = torch.zeros(shape, device=device)
    last = max(int(n.split(".")[1]) for n in shapes if n.startswith("dpt_bias_convs."))
    out[BIAS_OUTPUT.format(last=last)] += bias_output_offset
    missing = set(shapes) - set(out)
    if missing:
        raise KeyError(f"no draw for parameters {sorted(missing)}")
    return out


def shapes_of(module: torch.nn.Module) -> dict:
    return {n: tuple(p.shape) for n, p in module.named_parameters()}


def load(module: torch.nn.Module, state: dict) -> torch.nn.Module:
    """Copy ``state`` into ``module``'s parameters (every name must match)."""
    with torch.no_grad():
        params = dict(module.named_parameters())
        if set(params) != set(state):
            raise KeyError(f"weights and network differ: {sorted(set(params) ^ set(state))}")
        for name, p in params.items():
            p.copy_(state[name])
    return module
