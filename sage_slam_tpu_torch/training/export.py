"""Export trained networks for the SLAM runtime (port of
sage_slam_tpu/training/export.py).

The runtime consumes the same parameter layout the networks train in, so an
export splits a training state into per-network npz files whose dotted keys
``models.partial_unet.load_torch_state_dict`` (and the demo CLIs'
--depth_checkpoint / --feat_checkpoint flags) load directly, in either
package. The BA weights and the network sizes go beside them.
"""

from __future__ import annotations

import json
import numpy as np
import torch

from ..device import resolve_device


def flatten_params(net: torch.nn.Module) -> dict:
    """{dotted.path: np.ndarray} of a module's parameters: the keys of the
    JAX package's flatten_params over the same param tree."""
    return {n: p.detach().cpu().numpy() for n, p in net.named_parameters()}


def export_networks(state, out_prefix: str, depth_cfg=None, feat_cfg=None) -> dict:
    """Split a TrainState into per-network runtime files -> {name: path}:

    - ``{out_prefix}_depth.npz`` / ``_feat.npz`` / ``_disc.npz``: dotted-key
      parameter files for the demo loaders;
    - ``{out_prefix}_ba.npz``: the learnt BA weights and log_sigma;
    - ``{out_prefix}_netcfg.json``: the network configs (when given), which
      ``load_net_configs`` reads back.
    The keys and the JSON are the JAX package's."""
    paths = {}
    if depth_cfg is not None or feat_cfg is not None:
        cfgs = {}
        if depth_cfg is not None:
            cfgs["depth"] = depth_cfg._asdict()
        if feat_cfg is not None:
            cfgs["feat"] = feat_cfg._asdict()
        path = f"{out_prefix}_netcfg.json"
        with open(path, "w") as f:
            json.dump(cfgs, f, indent=2)
        paths["netcfg"] = path
    for name in ("depth", "feat", "disc"):
        path = f"{out_prefix}_{name}.npz"
        np.savez(path, **flatten_params(state.params[name]))
        paths[name] = path
    ba = state.params["ba"]
    ba_flat = {name: getattr(ba, name).detach().cpu().numpy() for name in ba._fields}
    ba_flat["log_sigma"] = state.params["log_sigma"].detach().cpu().numpy()
    path = f"{out_prefix}_ba.npz"
    np.savez(path, **ba_flat)
    paths["ba"] = path
    return paths


def load_net_configs(path: str):
    """(DepthNetConfig, FeatureNetConfig) from a _netcfg.json sidecar (either
    is None where its section is absent). JSON lists become the tuples the
    NamedTuple configs hold."""
    from ..models.depth_network import DepthNetConfig
    from ..models.feature_network import FeatureNetConfig

    def detuple(v):
        if isinstance(v, list):
            return tuple(detuple(x) for x in v)
        return v

    with open(path) as f:
        raw = json.load(f)
    depth_cfg = (
        DepthNetConfig(**{k: detuple(v) for k, v in raw["depth"].items()}) if "depth" in raw else None
    )
    feat_cfg = (
        FeatureNetConfig(**{k: detuple(v) for k, v in raw["feat"].items()}) if "feat" in raw else None
    )
    return depth_cfg, feat_cfg


def load_ba_params(path: str, device=None):
    """BAParams from an exported _ba.npz (the inverse of export_networks)."""
    from .diff_ba import BAParams

    dev = resolve_device(device)
    d = dict(np.load(path))
    return BAParams(*(torch.tensor(d[n], dtype=torch.float32, device=dev) for n in BAParams._fields))
