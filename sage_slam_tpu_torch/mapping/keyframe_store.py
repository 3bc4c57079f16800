"""Keyframe store: a fixed-capacity struct of tensors (port of
sage_slam_tpu/mapping/keyframe_store.py).

Every per-keyframe tensor lives in one stacked array with a keyframe axis
(pyramids channel-major, [C, K, T], so the flat view [C, K*T] the factors
gather from is free), allocated once and written row by row in place.
Graph topology (links, loop-search flags, versions) stays on the host.

Concurrency. The JAX store is functional: a snapshot is an immutable
array. Here rows are written in place, so ``snapshot`` clones the
variables, and the mapper gathers its compact window under ``lock``
before it releases it for the solve. ``merge_variables`` keeps the JAX
rules: a row created after the snapshot, or rewritten during the solve
(its ``version`` moved: a loop closure wins), keeps the store's value.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Set

import numpy as np
import torch

from ..geometry.se3 import SE3
from ..ops.depth import decode_depth
from ..ops.photometric import FrameTables
from ..solver.ba import WindowData
from ..solver.graph import Variables


@dataclasses.dataclass
class FrameData:
    """Per-frame tensors produced by Mapper.build_frame."""

    timestamp: float
    bias_flat: torch.Tensor  # [HW]
    jac_flat: torch.Tensor  # [HW, CS]
    feat_pyr: torch.Tensor  # [C, T]
    grad_pyr: torch.Tensor  # [2, C, T]
    feat_desc_flat: torch.Tensor  # [HW, C]
    src_feats: torch.Tensor  # [L, N, C] per-level sampled source features
    loc1d: torch.Tensor  # [N] sampled photometric pixels
    homo: torch.Tensor  # [N, 3]
    avg_sq_bias: torch.Tensor  # scalar tensor, stays on the device
    pose: SE3
    code: torch.Tensor  # [CS]
    scale: float
    # the frame's own sampling and decode tables (K=1), so a mapping step
    # never rebuilds them for the window
    tables: Optional[FrameTables] = None


class KeyframeStore:
    def __init__(self, capacity: int, num_samples: int, hw: int, cs: int, fs: int,
                 total_pyr: int, levels: int = 4, dtype=torch.float32, device=None):
        self.capacity = capacity
        self.num_active = 0
        self.device = device
        k = capacity
        z = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)  # noqa: E731
        self.variables = Variables(
            pose=SE3.identity((k,), dtype, device),
            code=z(k, cs),
            scale=torch.ones(k, dtype=dtype, device=device),
        )
        self.loc1d = torch.zeros((k, num_samples), dtype=torch.int64, device=device)
        self.homo = z(k, num_samples, 3)
        self.bias_flat = z(k, hw)
        self.jac_flat = z(k, hw, cs)
        self.feat_pyr = z(fs, k, total_pyr)
        self.src_feats = z(k, levels, num_samples, fs)
        self.grad_pyr = z(2, fs, k, total_pyr)
        self.feat_desc = z(k, hw, fs)
        self.avg_sq_bias = z(k)
        # sampling tables, allocated from the first added frame's shapes
        self.tables: Optional[FrameTables] = None
        # host-side metadata
        self.timestamps: List[float] = []
        self.reinitialize_count = np.zeros(k, np.int32)
        self.links: Dict[int, Set[int]] = {}
        self.global_loop_links: Set[tuple] = set()
        # which keyframes each loop backend has searched (a loop tick takes
        # the newest unsearched one)
        self.local_loop_searched = np.zeros(k, bool)
        self.global_loop_searched = np.zeros(k, bool)
        # aux (non-keyframe) frames: pose-only variables in BA
        self.aux = np.zeros(k, bool)
        # `lock` guards multi-field mutations and snapshot reads; `version[i]`
        # moves whenever row i is (re)written outside a mapping solve
        self.lock = threading.RLock()
        self.version = np.zeros(k, np.int64)

    def add(self, fr: FrameData) -> int:
        """Append a keyframe; returns its id (= row index)."""
        with self.lock:
            return self._add_locked(fr)

    def write_tables(self, i: int, tables: FrameTables):
        """Write one frame's tables (K=1) into row i, allocating the store's
        from their shapes at the first write (call under ``lock``). The
        pixel rows come with every frame's tables or with none (frames
        converted from the JAX package lack them)."""
        if self.tables is None:
            self.tables = FrameTables.zeros(self.capacity, tables, self.device)
        self.tables.write(i, tables)

    def _add_locked(self, fr: FrameData) -> int:
        i = self.num_active
        if i >= self.capacity:
            raise RuntimeError("keyframe store capacity exceeded")
        v = self.variables
        v.pose.rot[i] = fr.pose.rot
        v.pose.trans[i] = fr.pose.trans
        v.code[i] = fr.code
        v.scale[i] = fr.scale
        self.loc1d[i] = fr.loc1d
        self.homo[i] = fr.homo
        self.bias_flat[i] = fr.bias_flat
        self.jac_flat[i] = fr.jac_flat
        self.feat_pyr[:, i] = fr.feat_pyr
        self.src_feats[i] = fr.src_feats
        self.grad_pyr[:, :, i] = fr.grad_pyr
        self.feat_desc[i] = fr.feat_desc_flat
        self.avg_sq_bias[i] = fr.avg_sq_bias
        if fr.tables is not None:
            self.write_tables(i, fr.tables)
        self.timestamps.append(fr.timestamp)
        self.links[i] = set()
        self.version[i] += 1
        self.num_active += 1
        return i

    def add_link(self, a: int, b: int, global_loop: bool = False):
        """Undirected link."""
        self.links.setdefault(a, set()).add(b)
        self.links.setdefault(b, set()).add(a)
        if global_loop:
            self.global_loop_links.add((min(a, b), max(a, b)))

    def link_exists(self, a: int, b: int) -> bool:
        return b in self.links.get(a, set())

    def connections(self, a: int, temporal_only: bool = False):
        out = sorted(self.links.get(a, set()))
        if temporal_only:
            out = [b for b in out if (min(a, b), max(a, b)) not in self.global_loop_links]
        return out

    def window_data(self, mask_flat: torch.Tensor) -> WindowData:
        """The whole store as a BA window (views, no copies)."""
        return WindowData(
            loc1d=self.loc1d, homo=self.homo, bias_flat=self.bias_flat,
            jac_flat=self.jac_flat, feat_pyr=self.feat_pyr, grad_pyr=self.grad_pyr,
            src_feats=self.src_feats, avg_sq_bias=self.avg_sq_bias, mask_flat=mask_flat,
            tables=self.tables,
        )

    def nbytes(self) -> int:
        """Bytes of every device tensor the store holds."""
        tensors = [
            *self.variables.pose, self.variables.code, self.variables.scale, self.loc1d,
            self.homo, self.bias_flat, self.jac_flat, self.feat_pyr, self.src_feats,
            self.grad_pyr, self.feat_desc, self.avg_sq_bias,
        ]
        tables = 0 if self.tables is None else self.tables.nbytes()
        return tables + sum(t.numel() * t.element_size() for t in tensors)

    def snapshot(self):
        """(num_active, version copy, cloned variables) for a backend solve;
        call under ``lock``."""
        v = self.variables
        clone = Variables(SE3(v.pose.rot.clone(), v.pose.trans.clone()), v.code.clone(),
                          v.scale.clone())
        return self.num_active, self.version.copy(), clone

    def merge_variables(self, variables: Variables, snap_version: np.ndarray, snap_n: int):
        """Merge a backend's solved variables (call under ``lock``): rows
        created after the snapshot or rewritten during the solve keep the
        store's value; every other row takes the solve's."""
        keep_rows = self.version != snap_version
        keep_rows[snap_n:] = True
        if not keep_rows.any():
            self.variables = variables
            return
        keep = torch.as_tensor(keep_rows, device=variables.scale.device)
        cur = self.variables
        self.variables = Variables(
            pose=SE3(
                torch.where(keep[:, None, None], cur.pose.rot, variables.pose.rot),
                torch.where(keep[:, None], cur.pose.trans, variables.pose.trans),
            ),
            code=torch.where(keep[:, None], cur.code, variables.code),
            scale=torch.where(keep, cur.scale, variables.scale),
        )

    def pose(self, i: int) -> SE3:
        return SE3(self.variables.pose.rot[i], self.variables.pose.trans[i])

    def row(self, name: str, i: int) -> torch.Tensor:
        """Row i of any stacked per-keyframe array."""
        if name == "feat_pyr":
            return self.feat_pyr[:, i]
        if name == "grad_pyr":
            return self.grad_pyr[:, :, i]
        return getattr(self, name)[i]

    def depth_map(self, i: int) -> torch.Tensor:
        """Decoded scaled depth of keyframe i [HW]."""
        v = self.variables
        return decode_depth(self.bias_flat[i], self.jac_flat[i], v.code[i], v.scale[i])
