"""SLAM state checkpoint and resume (port of
sage_slam_tpu/mapping/serialize.py).

The whole SLAM state (the keyframe store's rows, the variables, the graph
edges with their iteration budgets, the trajectory, the current keyframe
and pose) goes into one npz in the JAX package's format: the same keys and
dtypes, so a checkpoint written by either package loads in the other.

What the format holds, and so what a resume restores, is JAX's: it has no
BoW database (a resumed system queries an empty one until new keyframes
arrive), no loop-search flags, no per-frame references of the finalized
trajectory (it restarts at the resume point) and no reprojection edges
(the mapper adds none by default).

Two departures from the JAX ``load_state``, which restores the rows and
nothing derived from them:

* the derived tables of every restored row (``src_feats`` and its
  FrameTables: the packed and dense sampling tables, ``bias_at``,
  ``jac_at``, the prep kernel's rows) are rebuilt with the functions
  build_frame uses (Mapper.frame_tables); JAX leaves
  ``src_feats`` at zeros and the tables unset, so its resumed mapping step
  solves a different problem;
* the mapper's priors are rebuilt: the first keyframe anchors the pose,
  and its scale prior targets the scale init_one_frame gave it, which the
  saved row determines (the frame enters with a zero code and scale 1, so
  the target is 1 / |median of its depth bias over the mask|).

``load_state`` writes into the store allocated once, in place: no store
tensor is rebound, and each restored row's version moves, so a mapping
solve that snapshotted before the load keeps the restored rows when it
merges.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..geometry.se3 import SE3
from .mapper import median

# the store's rows in the file: (key, dtype of the file's array)
ROWS = (
    ("loc1d", np.int32), ("homo", np.float32), ("bias_flat", np.float32),
    ("jac_flat", np.float32), ("feat_pyr", np.float32), ("grad_pyr", np.float32),
    ("feat_desc", np.float32), ("avg_sq_bias", np.float32),
)


def _edges(edges) -> np.ndarray:
    return np.array(edges, np.int64).reshape(-1, 2) if edges else np.zeros((0, 2), np.int64)


def save_state(path: str, system) -> None:
    store, mapper = system.store, system.mapper
    with store.lock:
        v = store.variables
        host = {
            "pose_rot": v.pose.rot, "pose_trans": v.pose.trans, "code": v.code, "scale": v.scale,
            **{name: getattr(store, name) for name, _ in ROWS},
        }
        host = {k: t.cpu().numpy() for k, t in host.items()}
        payload = {
            "num_active": store.num_active,
            "pose_rot": host["pose_rot"], "pose_trans": host["pose_trans"],
            "code": host["code"], "scale": host["scale"],
            **{name: host[name].astype(dtype) for name, dtype in ROWS},
            "reinitialize_count": store.reinitialize_count.copy(),
            "aux": store.aux.copy(),
            "timestamps": np.array(store.timestamps, np.float64),
            "photo_edges": _edges(mapper.photo_edges),
            "geo_edges": _edges(mapper.geo_edges),
            "photo_edge_iters": np.array(mapper.photo_edge_iters, np.int64),
            "geo_edge_iters": np.array(mapper.geo_edge_iters, np.int64),
            "links": json.dumps({str(k): sorted(s) for k, s in store.links.items()}),
            "global_loop_links": json.dumps(sorted(list(store.global_loop_links))),
        }
    traj = system.trajectory
    payload["trajectory_ts"] = np.array([t for t, _ in traj], np.float64)
    if traj:  # one read for the whole trajectory
        payload["trajectory_rot"] = torch.stack([p.rot for _, p in traj]).cpu().numpy()
        payload["trajectory_trans"] = torch.stack([p.trans for _, p in traj]).cpu().numpy()
    else:
        payload["trajectory_rot"] = np.zeros((0, 3, 3))
        payload["trajectory_trans"] = np.zeros((0, 3))
    payload["curr_kf"] = system.curr_kf
    payload["pose_ck_rot"] = system.pose_ck.rot.cpu().numpy()
    payload["pose_ck_trans"] = system.pose_ck.trans.cpu().numpy()
    np.savez_compressed(path, **payload)


def load_state(path: str, system) -> None:
    """Restore a checkpoint into an already-constructed SlamSystem of the
    same configuration (see the module note)."""
    d = np.load(path, allow_pickle=False)
    store, mapper = system.store, system.mapper
    dev = system.device
    t = lambda key, dtype=torch.float32: torch.as_tensor(d[key], dtype=dtype, device=dev)  # noqa: E731
    fi = system.cfg.mapper.factor_iters
    with store.lock:
        n = int(d["num_active"])
        v = store.variables
        for dst, key in ((v.pose.rot, "pose_rot"), (v.pose.trans, "pose_trans"), (v.code, "code"),
                         (v.scale, "scale")):
            dst.copy_(t(key))
        for name, _ in ROWS:
            dst = getattr(store, name)
            dst.copy_(t(name, dst.dtype))
        store.num_active = n
        store.reinitialize_count[:] = d["reinitialize_count"]
        if "aux" in d:  # absent in checkpoints older than aux frames
            store.aux[:] = d["aux"]
        store.timestamps = [float(x) for x in d["timestamps"]]
        store.links = {int(k): set(s) for k, s in json.loads(str(d["links"])).items()}
        store.global_loop_links = {tuple(x) for x in json.loads(str(d["global_loop_links"]))}
        for i in range(n):
            derived = mapper.frame_tables(
                store.feat_pyr[:, i].contiguous(), store.grad_pyr[:, :, i].contiguous(),
                store.loc1d[i], store.bias_flat[i], store.jac_flat[i],
            )
            store.src_feats[i] = derived["src_feats"]
            store.write_tables(i, derived["tables"])
            store.version[i] += 1
        mapper.photo_edges = [tuple(int(x) for x in e) for e in d["photo_edges"]]
        mapper.geo_edges = [tuple(int(x) for x in e) for e in d["geo_edges"]]
        mapper.photo_edge_iters = (
            [int(x) for x in d["photo_edge_iters"]] if "photo_edge_iters" in d
            else [fi] * len(mapper.photo_edges)
        )
        mapper.geo_edge_iters = (
            [int(x) for x in d["geo_edge_iters"]] if "geo_edge_iters" in d
            else [fi] * len(mapper.geo_edges)
        )
        if n > 0:
            depth = store.bias_flat[0][mapper.valid_loc1d]
            mapper._init_scale_target = {0: 1.0 / max(abs(float(median(depth))), 1e-6)}
            mapper._pose_anchor = 0
    system.trajectory = [
        (float(ts), SE3(torch.as_tensor(r, device=dev), torch.as_tensor(tr, device=dev)))
        for ts, r, tr in zip(d["trajectory_ts"], d["trajectory_rot"].astype(np.float32),
                             d["trajectory_trans"].astype(np.float32))
    ]
    system.frame_refs = []
    system._visited = list(range(n))
    system.curr_kf = int(d["curr_kf"])
    system.pose_ck = SE3(t("pose_ck_rot"), t("pose_ck_trans"))
