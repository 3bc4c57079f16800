"""Network configuration sidecars (port of the loader in
sage_slam_tpu/training/export.py).

Only ``load_net_configs`` is ported: the demo reads the network sizes a
training run exported (``<prefix>_netcfg.json``, e.g.
eval_artifacts/net_netcfg.json). Exporting networks and the BA parameters
belongs to the training slice.
"""

from __future__ import annotations

import json


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
