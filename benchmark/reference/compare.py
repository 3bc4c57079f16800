"""The numbers that decide ``correct``, and their limits.

Every number is a gap between what the program produced and what the plain
reference recomputes from the same inputs. ``update_gap``: the BA step's
keyframe variables, the worst keyframe. Each item's gap is the difference
between the program's result and the reference's over how far the
reference moved from the common start (rotation distance plus translation
for a pose; for a keyframe's code and scale the largest entry), taken
against the larger of that item's own move and the median item's, so items
that barely move do not turn rounding into a large share; a result left at
its start reads 1.

Each cell's reference module holds its own limits, each set between the
largest reading of sound runs and the smallest reading of the control, as
PERF.md lists them; a new cell brings its own.
"""

from __future__ import annotations

import torch

def rel_max(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| / max |b|, in float64."""
    a, b = a.detach().double(), b.detach().double().to(a.device)
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def rot_angle(ra: torch.Tensor, rb: torch.Tensor) -> torch.Tensor:
    """Rotation distance [...] of ra and rb: ||ra - rb||_F / sqrt(2), the
    angle between them for small angles (2 sin(angle / 2) in general), in
    float64. Unlike an angle from the trace of ra^T rb, it does not turn
    the float32 matrices' departure from orthonormality into ~1e-4 rad."""
    d = ra.double() - rb.double().to(ra.device)
    return d.flatten(-2).norm(dim=-1) / 2 ** 0.5


def pose_diff(rot_a, trans_a, rot_b, trans_b) -> torch.Tensor:
    """Rotation angle plus translation distance, per pose [...]."""
    return rot_angle(rot_a, rot_b) + (trans_a.double() - trans_b.double().to(trans_a.device)).norm(dim=-1)


def moved_gap(diff: torch.Tensor, move: torch.Tensor, median: bool = False) -> float:
    """The largest (or with ``median``, the median) over items k of
    diff_k / max(move_k, median move), in float64."""
    diff, move = diff.double().reshape(-1), move.double().reshape(-1).to(diff.device)
    gap = diff / torch.maximum(move, move.median()).clamp(min=1e-30)
    return float(gap.median() if median else gap.max())


def check(name: str, value: float, limit: float) -> dict:
    return {"name": name, "value": value, "limit": limit}


def passes(checks: list) -> bool:
    """Every number read (none is NaN) and within its limit."""
    return all(c["value"] == c["value"] and c["value"] <= c["limit"] for c in checks)
