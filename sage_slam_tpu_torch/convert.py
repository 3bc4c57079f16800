"""State carried across from the JAX package's structures.

The functions take the fields of the JAX package's ``BAProblem``,
``Variables`` and ``CameraPyramid`` by field name, as numpy arrays: either
the JAX NamedTuples after ``jax.tree.map(np.asarray, ...)`` on the caller's
side, or plain mappings with the same keys. The port never imports JAX.

The photometric sample ids ``loc1d`` travel as data: the JAX package draws
them with ``jax.random.permutation``, which torch cannot reproduce.

Vocabularies (``vocabulary_from_numpy``) and verified loops
(``loop_info_from_numpy``) travel the same way, so a test can hand the JAX
system's loops to the port; TSDF volumes travel in both directions
(``tsdf_volume_from_numpy``, ``tsdf_volume_to_numpy``). Network weights
too: ``depth_params_from_numpy``,
``feature_params_from_numpy`` and ``disc_params_from_numpy`` take the JAX
param tree (nested dicts and lists of arrays) and fill the port's modules,
whose parameter names are the tree's paths joined by dots;
``train_params_from_numpy`` carries a whole training state's params and
``batch_from_numpy`` a training batch.

Tensors go to the card unless ``device="cpu"`` is passed; without CUDA a
call that did not ask for the CPU raises (device.resolve_device).
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

from .device import resolve_device
from .geometry.camera import CameraPyramid, PinholeCamera
from .geometry.se3 import SE3
from .ops.photometric import FrameTables
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


def _frame_tables(obj, dev, one_frame: bool) -> FrameTables | None:
    """The sampling tables the JAX package prepared for a window or one
    frame as FrameTables (None where it prepared none), a frame's decode
    tables given their keyframe axis. The pixel rows, which the JAX
    package lacks, are None; its mega tables are ignored (the port has no
    mega layout)."""
    if _opt_field(obj, "packed_fg") is None:
        return None

    def decode(name):
        x = _opt_field(obj, name)
        return None if x is None else _tensor(np.asarray(x)[None] if one_frame else x, dev)

    return FrameTables(
        _tensor(_field(obj, "packed_fg"), dev), _tensor(_field(obj, "packed_feat"), dev),
        *(tuple(_tensor(t, dev) for t in _field(obj, f)) for f in ("dense_fg", "dense_feat")),
        decode("bias_at"), decode("jac_at"), None,
    )


def problem_from_numpy(p, device=None) -> BAProblem:
    """A BAProblem from the JAX package's problem fields. Tables that the
    JAX side already prepared are carried over (_frame_tables: not its
    mega tables); otherwise solver.ba.prepare_problem builds them."""
    dev = resolve_device(device)
    w = _field(p, "window")
    base = {
        f: _tensor(_field(w, f), dev)
        for f in ("loc1d", "homo", "bias_flat", "jac_flat", "feat_pyr", "grad_pyr",
                  "src_feats", "avg_sq_bias", "mask_flat")
    }
    window = WindowData(**base, tables=_frame_tables(w, dev, one_frame=False))
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


def _flatten_params(tree, prefix=""):
    """A JAX param tree (nested dicts / lists of arrays) -> {dotted name:
    array}, the names of the port's state_dict."""
    if isinstance(tree, Mapping):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for key, sub in items:
        out.update(_flatten_params(sub, f"{prefix}.{key}" if prefix else str(key)))
    return out


def _load_params(net: torch.nn.Module, params, device):
    dev = resolve_device(device)
    state = {name: _tensor(arr, "cpu") for name, arr in _flatten_params(params).items()}
    net.load_state_dict(state, strict=True)
    return net.to(dev)


def depth_params_from_numpy(params, cfg=None, device=None):
    """A DepthNetwork carrying the JAX depth net's params (nested dicts /
    lists of numpy arrays, or a torch state_dict by the same names)."""
    from .models.depth_network import DepthNetConfig, DepthNetwork

    return _load_params(DepthNetwork(cfg or DepthNetConfig()), params, device)


def feature_params_from_numpy(params, cfg=None, device=None):
    """A FeatureNetwork carrying the JAX feature net's params."""
    from .models.feature_network import FeatureNetConfig, FeatureNetwork

    return _load_params(FeatureNetwork(cfg or FeatureNetConfig()), params, device)


def disc_params_from_numpy(params, cfg=None, device=None):
    """A Discriminator carrying the JAX discriminator's params."""
    from .training.discriminator import DiscConfig, Discriminator

    return _load_params(Discriminator(cfg or DiscConfig()), params, device)


def ba_params_from_numpy(ba, device=None):
    """The port's BAParams (0-d float32 tensors) from the JAX BAParams or a
    mapping with its field names."""
    from .training.diff_ba import BAParams

    dev = resolve_device(device)
    return BAParams(*(_tensor(_field(ba, name), dev).reshape(()) for name in BAParams._fields))


def train_params_from_numpy(params, depth_cfg=None, feat_cfg=None, disc_cfg=None, device=None):
    """The trainer's params dict from the JAX trainer's (depth, feat, ba,
    log_sigma, disc as numpy trees); every leaf requires grad."""
    dev = resolve_device(device)
    ba = ba_params_from_numpy(params["ba"], dev)
    return {
        "depth": depth_params_from_numpy(params["depth"], depth_cfg, dev),
        "feat": feature_params_from_numpy(params["feat"], feat_cfg, dev),
        "ba": type(ba)(*(t.requires_grad_(True) for t in ba)),
        "log_sigma": _tensor(params["log_sigma"], dev).reshape(()).requires_grad_(True),
        "disc": disc_params_from_numpy(params["disc"], disc_cfg, dev),
    }


def batch_from_numpy(batch, device=None) -> dict:
    """A training batch (the JAX triplet_to_batch dict) as tensors: integer
    arrays int64, the rest float32."""
    dev = resolve_device(device)
    return {k: _tensor(v, dev) for k, v in batch.items()}


def frame_from_numpy(fr, device=None):
    """The port's FrameData from the JAX package's FrameData fields, the
    per-frame tables included (_frame_tables: not the JAX package's mega
    tables, and no pixel rows)."""
    from .mapping.keyframe_store import FrameData

    dev = resolve_device(device)
    t = lambda name: _tensor(_field(fr, name), dev)  # noqa: E731
    return FrameData(
        timestamp=float(_field(fr, "timestamp")),
        bias_flat=t("bias_flat"),
        jac_flat=t("jac_flat"),
        feat_pyr=t("feat_pyr"),
        grad_pyr=t("grad_pyr"),
        feat_desc_flat=t("feat_desc_flat"),
        src_feats=t("src_feats"),
        loc1d=t("loc1d"),
        homo=t("homo"),
        avg_sq_bias=t("avg_sq_bias"),
        pose=_se3(_field(fr, "pose"), dev),
        code=t("code"),
        scale=float(_field(fr, "scale")),
        tables=_frame_tables(fr, dev, one_frame=True),
    )


def to_device(tree, device):
    """Copy every tensor of a (nested) NamedTuple / tuple / dataclass (a
    FrameData) to ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: to_device(getattr(tree, f.name), device) for f in dataclasses.fields(tree)
        })
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_device(x, device) for x in tree))
    if isinstance(tree, tuple):
        return tuple(to_device(x, device) for x in tree)
    return tree


def vocabulary_from_numpy(voc, device=None):
    """The port's Vocabulary from the JAX Vocabulary's fields (children,
    descriptors, weights, word_ids, num_words, levels)."""
    from .loop.vocabulary import vocabulary_from_arrays

    return vocabulary_from_arrays(*(np.asarray(_field(voc, f)) for f in (
        "children", "descriptors", "weights", "word_ids")), int(_field(voc, "num_words")),
        int(_field(voc, "levels")), device=device)


def loop_info_from_numpy(info, device=None):
    """The port's LoopInfo from the JAX LoopInfo's fields (``pose_cur_ref``
    with rot and trans, or None)."""
    from .frontend.slam import LoopInfo

    dev = resolve_device(device)
    pose = _opt_field(info, "pose_cur_ref")
    return LoopInfo(
        detected=bool(_field(info, "detected")), id_ref=int(_field(info, "id_ref")),
        pose_cur_ref=None if pose is None else _se3(pose, dev),
        query_scale=float(_field(info, "query_scale")), ref_scale=float(_field(info, "ref_scale")),
        desc_inlier_ratio=float(_field(info, "desc_inlier_ratio")), quality=float(_field(info, "quality")),
    )


def tsdf_volume_from_numpy(vol, device=None):
    """The port's TSDFVolume from a JAX TSDFVolume's fields (tsdf, weight,
    origin, voxel_size, trunc)."""
    from .eval.tsdf import TSDFVolume

    dev = resolve_device(device)
    return TSDFVolume(
        tsdf=_tensor(_field(vol, "tsdf"), dev), weight=_tensor(_field(vol, "weight"), dev),
        origin=_tensor(_field(vol, "origin"), dev), voxel_size=float(_field(vol, "voxel_size")),
        trunc=float(_field(vol, "trunc")),
    )


def tsdf_volume_to_numpy(vol) -> dict:
    """A port TSDFVolume as {field: numpy array or float}, the keyword
    arguments of a JAX TSDFVolume once its arrays are wrapped."""
    return dict(
        tsdf=vol.tsdf.cpu().numpy(), weight=vol.weight.cpu().numpy(), origin=vol.origin.cpu().numpy(),
        voxel_size=vol.voxel_size, trunc=vol.trunc,
    )
