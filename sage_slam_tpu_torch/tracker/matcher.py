"""Descriptor matching with cycle consistency (port of
sage_slam_tpu/tracker/matcher.py).

1. select K random valid pixels of frame 0 (seeded),
2. nearest-neighbour match descriptors into frame 1 (argmin of the squared
   distance, ||a-b||^2 = |a|^2 + |b|^2 - 2 a.b as one product),
3. match back 1 -> 0 and keep keypoints whose cycle lands within
   ``cyc_consis_thresh`` pixels of where they started.

All K keypoints are kept; failures are masked. The JAX package draws the
keypoints with ``jax.random.permutation``, which torch cannot reproduce:
here they come from ``torch.randperm`` on a seeded CPU generator, so the
card and the CPU draw the same ids, and tests pass the JAX ids as data.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry.interp import locations_1d_to_2d, locations_1d_to_homo


class Matches(NamedTuple):
    loc1d_0: torch.Tensor  # [K] keypoint pixel ids in frame 0
    loc1d_1: torch.Tensor  # [K] matched pixel ids in frame 1
    valid: torch.Tensor  # [K] 0/1 cycle-consistency survivors


def select_keypoints(seed: int, valid_locations_1d: torch.Tensor, num_keypoints: int):
    """A seeded random subset of the valid pixel ids, without replacement."""
    gen = torch.Generator().manual_seed(int(seed))
    perm = torch.randperm(valid_locations_1d.shape[0], generator=gen)
    return valid_locations_1d[perm[:num_keypoints].to(valid_locations_1d.device)]


def _nn_match(desc_q: torch.Tensor, desc_db: torch.Tensor) -> torch.Tensor:
    """argmin_p ||q_k - db_p||^2: desc_q [K, C], desc_db [HW, C] -> [K]."""
    q2 = torch.sum(desc_q**2, dim=-1, keepdim=True)
    db2 = torch.sum(desc_db**2, dim=-1)[None, :]
    dist = q2 + db2 - 2.0 * (desc_q @ desc_db.T)
    return torch.argmin(dist, dim=-1)


def cycle_consistent_matches(keypoint_loc1d, desc0_flat, desc1_flat, width: int,
                             cyc_consis_thresh: float) -> Matches:
    """NN match 0 -> 1, then 1 -> 0; keep the cycle-consistent keypoints."""
    kp = keypoint_loc1d.long()
    match1 = _nn_match(desc0_flat[kp], desc1_flat)
    back0 = _nn_match(desc1_flat[match1], desc0_flat)
    x0, y0 = locations_1d_to_2d(kp, width)
    xb, yb = locations_1d_to_2d(back0, width)
    dist_sq = (x0 - xb) ** 2 + (y0 - yb) ** 2
    valid = (dist_sq <= cyc_consis_thresh**2).to(desc0_flat.dtype)
    return Matches(kp, match1, valid)


def matches_to_points(matches: Matches, cam):
    """Homogeneous rays for both sides of a match set."""
    return (
        locations_1d_to_homo(matches.loc1d_0, cam),
        locations_1d_to_homo(matches.loc1d_1, cam),
    )
