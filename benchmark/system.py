"""The system under test's networks, built from a configuration file and
the seeded weights.

The configuration's ``networks`` group gives the program's
``DepthNetConfig`` and ``FeatureNetConfig`` fields. The depth network takes
the weights ``weights.depth_state`` draws from the seed; the feature
network runs in the mode the file names (``"handcrafted"``: a fixed filter
bank, no weights used).
"""

from __future__ import annotations

import torch

from . import weights
from .reference.frames import net_kwargs


def networks(config: dict, seed: int, device):
    """-> (the program's depth network, its feature network, the depth
    weights {name: tensor} on ``device``)."""
    from sage_slam_tpu_torch.models import depth_network, feature_network

    nets = config["networks"]
    depth = depth_network.DepthNetwork(depth_network.DepthNetConfig(**net_kwargs(nets["depth"])))
    depth = depth.to(device)
    state = weights.depth_state(weights.shapes_of(depth), seed, device)
    weights.load(depth, state)
    feat = feature_network.FeatureNetwork(
        feature_network.FeatureNetConfig(**net_kwargs(nets["feature"]))).to(device)
    return depth, feat, state


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
