"""State carried across from the JAX package's structures.

The functions take the fields of the JAX package's ``BAProblem``,
``Variables`` and ``CameraPyramid`` by field name, as numpy arrays: either
the JAX NamedTuples after ``jax.tree.map(np.asarray, ...)`` on the caller's
side, or plain mappings with the same keys. The port never imports JAX.

The photometric sample ids ``loc1d`` travel as data: the JAX package draws
them with ``jax.random.permutation``, which torch cannot reproduce.

Tensors go to the card unless ``device="cpu"`` is passed; without CUDA a
call that did not ask for the CPU raises (device.resolve_device).
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from .device import resolve_device
from .geometry.camera import CameraPyramid, PinholeCamera
from .geometry.se3 import SE3
from .solver.ba import BAProblem, EdgeTable, PriorTable, ReprojEdgeTable, WindowData
from .solver.graph import Variables


def _field(obj, name):
    return obj[name] if isinstance(obj, Mapping) else getattr(obj, name)


def _opt_field(obj, name):
    if isinstance(obj, Mapping):
        return obj.get(name)
    return getattr(obj, name, None)


def _tensor(x, device) -> torch.Tensor:
    arr = np.asarray(x)
    if np.issubdtype(arr.dtype, np.integer):
        arr = arr.astype(np.int64)
    elif arr.dtype != np.float32:
        arr = arr.astype(np.float32)
    return torch.tensor(arr, device=device)


def _se3(p, device) -> SE3:
    return SE3(_tensor(_field(p, "rot"), device), _tensor(_field(p, "trans"), device))


def camera_pyramid_from_numpy(pyr) -> CameraPyramid:
    """A CameraPyramid from an object or mapping with ``cameras``, each
    with fx, fy, cx, cy, width, height."""
    cams = []
    for cam in _field(pyr, "cameras"):
        cams.append(
            PinholeCamera(
                fx=float(_field(cam, "fx")), fy=float(_field(cam, "fy")),
                cx=float(_field(cam, "cx")), cy=float(_field(cam, "cy")),
                width=int(_field(cam, "width")), height=int(_field(cam, "height")),
            )
        )
    return CameraPyramid(tuple(cams))


def variables_from_numpy(v, device=None) -> Variables:
    dev = resolve_device(device)
    return Variables(
        _se3(_field(v, "pose"), dev),
        _tensor(_field(v, "code"), dev),
        _tensor(_field(v, "scale"), dev),
    )


def _edges(e, device) -> EdgeTable:
    return EdgeTable(*(_tensor(_field(e, f), device) for f in EdgeTable._fields))


def problem_from_numpy(p, device=None) -> BAProblem:
    """A BAProblem from the JAX package's problem fields. Gather tables
    that the JAX side already prepared are carried over; otherwise
    solver.ba.prepare_problem builds them. The default-off mega tables
    are not ported and must be absent."""
    dev = resolve_device(device)
    w = _field(p, "window")
    for name in ("mega_fg", "mega_feat"):
        if _opt_field(w, name) is not None:
            raise NotImplementedError(f"window.{name}: mega tables are not ported")
    base = {f: _tensor(_field(w, f), dev) for f in WindowData._fields[:9]}
    prepared = {}
    if _opt_field(w, "packed_fg") is not None:
        for f in ("packed_fg", "packed_feat", "bias_at", "jac_at"):
            prepared[f] = _tensor(_field(w, f), dev)
        for f in ("dense_fg", "dense_feat"):
            prepared[f] = tuple(_tensor(t, dev) for t in _field(w, f))
    window = WindowData(**base, **prepared)
    pr = _field(p, "priors")
    priors = PriorTable(
        code_valid=_tensor(_field(pr, "code_valid"), dev),
        scale_valid=_tensor(_field(pr, "scale_valid"), dev),
        scale_init=_tensor(_field(pr, "scale_init"), dev),
        pose_valid=_tensor(_field(pr, "pose_valid"), dev),
        pose_target=_se3(_field(pr, "pose_target"), dev),
    )
    re = _opt_field(p, "reproj_edges")
    reproj = None
    if re is not None:
        reproj = ReprojEdgeTable(
            *(_tensor(_field(re, f), dev) for f in ReprojEdgeTable._fields)
        )
    return BAProblem(
        window,
        _edges(_field(p, "photo_edges"), dev),
        _edges(_field(p, "geo_edges"), dev),
        priors,
        reproj,
    )


def to_device(tree, device):
    """Copy every tensor of a (nested) NamedTuple / tuple to ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_device(x, device) for x in tree))
    if isinstance(tree, tuple):
        return tuple(to_device(x, device) for x in tree)
    return tree
