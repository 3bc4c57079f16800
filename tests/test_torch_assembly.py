"""The Hessian assembly's contract (solver/graph.scatter_hessian) on the
plain path, against a float64 ``index_add_`` sum of the same blocks: each
edge adds valid² · ata at (gidx, gidx) and valid · atb at gidx, repeated
slots of one edge all summed, indices outside [0, D) and edges with valid 0
placing nothing; the span counts the E·S·S entries placed. The card's
kernel is held to the same sum, on the problems built here, in
tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from sage_slam_tpu_torch.solver import graph
from sage_slam_tpu_torch.utils import timing


def index_add_sum(h, b, gidx, ata, atb, valid):
    """float64 H and b with every edge's valid² · block and valid · vector
    added entry by entry (indices outside [0, D) dropped), on the CPU."""
    h, b, gidx, ata, atb, valid = (t.cpu() for t in (h, b, gidx, ata, atb, valid))
    d = h.shape[-1]
    e, s = gidx.shape
    keep = (gidx >= 0) & (gidx < d)
    pair = keep[:, :, None] & keep[:, None, :]
    v = valid.double()
    hs = h.double().reshape(-1).clone()
    hs.index_add_(0, (gidx[:, :, None] * d + gidx[:, None, :])[pair],
                  (ata.double() * (v * v)[:, None, None]).expand(e, s, s)[pair])
    bs = b.double().clone()
    bs.index_add_(0, gidx[keep], (atb.double() * v[:, None]).expand(e, s)[keep])
    return hs.reshape(d, d), bs


def assembly_case(k, cs, kind, e=0, seed=0, block_dim=None):
    """(h, b, gidx, ata, atb, valid, block_dim) on the CPU, in the layouts
    ba.linearize and the pose graph give: photo (p0, p1, c0, s0) and geo
    (p0, p1, c0, c1, s0, s1) edges between each keyframe and its three
    predecessors, both ways, as the full-graph cells' maps have them (or e
    random pairs); the code, pose and scale priors of every keyframe, the
    code and pose ones as stride-0 expanded blocks as ops/priors makes
    them; the pose graph's (p0, p1, s0, s1) at block width 7. Blocks are
    symmetric through psd_correct, as every caller's are."""
    rng = np.random.default_rng(seed)
    bd = block_dim or (7 if kind == "pose_graph" else 7 + cs)
    pose, code, scale = torch.arange(6), torch.arange(6, 6 + cs), torch.arange(6 + cs, 7 + cs)
    if kind.startswith("prior"):
        sel = {"prior_code": code, "prior_pose": pose, "prior_scale": scale}[kind]
        gidx = graph.slot_indices(torch.arange(k), bd, sel)
        s = gidx.shape[1]
        if kind == "prior_scale":
            ata = torch.from_numpy(rng.random((k, 1, 1)).astype(np.float32) + 0.5)
        else:
            ata = (3.0 * torch.eye(s)).expand(k, s, s)
        atb = torch.from_numpy(rng.standard_normal((k, s)).astype(np.float32))
        valid = torch.from_numpy((rng.random(k) > 0.3).astype(np.float32))
    else:
        if e:
            i0 = torch.from_numpy(rng.integers(0, k, e))
            i1 = (i0 + 1 + torch.from_numpy(rng.integers(0, k - 1, e))) % k
        else:
            pairs = [(i, j) for i in range(1, k) for j in range(max(0, i - 3), i)]
            i0 = torch.tensor([p for i, j in pairs for p in (i, j)])
            i1 = torch.tensor([p for i, j in pairs for p in (j, i)])
        parts = {"photo": [(i0, pose), (i1, pose), (i0, code), (i0, scale)],
                 "geo": [(i0, pose), (i1, pose), (i0, code), (i1, code), (i0, scale), (i1, scale)],
                 "pose_graph": [(i0, pose), (i1, pose), (i0, scale), (i1, scale)]}[kind]
        gidx = torch.cat([graph.slot_indices(kf, bd, sel) for kf, sel in parts], dim=-1)
        e, s = gidx.shape
        a = torch.from_numpy(rng.standard_normal((e, s, s)).astype(np.float32))
        ata = graph.psd_correct(a @ a.transpose(1, 2))
        atb = torch.from_numpy(rng.standard_normal((e, s)).astype(np.float32))
        valid = torch.ones(e)
    h, b = graph.empty_system(k, bd)
    return h, b, gidx, ata, atb, valid, bd


VARIANTS = ["no_edges", "all_invalid", "repeated_slots", "accumulate", "weighted_valid",
            "outside_d", "wide_block"]


def variant_case(variant):
    """20 random geometric edges over 8 keyframes (CS=4), changed as
    ``variant`` says: no edges, every edge invalid, slots of one edge that
    repeat a global index, a non-zero symmetric h and b to add onto, valid
    weights other than 0/1, indices outside [0, D), or a block width of 70
    (wider than the kernel's largest tile)."""
    h, b, gidx, ata, atb, valid, bd = assembly_case(
        8, 4, "geo", e=20, seed=7, block_dim=70 if variant == "wide_block" else None)
    d = h.shape[0]
    rng = np.random.default_rng(3)
    if variant == "no_edges":
        gidx, ata, atb, valid = gidx[:0], ata[:0], atb[:0], valid[:0]
    elif variant == "all_invalid":
        valid = torch.zeros_like(valid)
    elif variant == "repeated_slots":
        gidx[0, 3] = gidx[0, 9]
        gidx[1, :] = gidx[1, 0]
        gidx[2, 20:] = gidx[2, 20]
    elif variant == "accumulate":
        x = torch.from_numpy(rng.standard_normal((d, d)).astype(np.float32))
        h, b = x + x.T, torch.from_numpy(rng.standard_normal(d).astype(np.float32))
    elif variant == "weighted_valid":
        valid = torch.from_numpy(rng.choice([0.0, 0.5, 2.0, -1.0, 1.0], size=valid.shape[0])
                                 .astype(np.float32))
    elif variant == "outside_d":
        gidx[3, 0], gidx[4, 5], gidx[5, -1] = -1, d, d + 70
    return h, b, gidx, ata, atb, valid, bd


SMALL = {"photo": (6, 4, "photo"), "geo": (6, 4, "geo"), "pose_graph": (9, 0, "pose_graph"),
         "prior_code": (6, 4, "prior_code"), "prior_pose": (6, 4, "prior_pose"),
         "prior_scale": (6, 4, "prior_scale")}


@pytest.mark.parametrize("case", list(SMALL) + VARIANTS)
def test_scatter_hessian_matches_index_add_sum(case):
    """The plain path against the float64 sum, to float32 roundoff; the
    span counts E·S·S entries and no kernel call."""
    if case in SMALL:
        h, b, gidx, ata, atb, valid, bd = assembly_case(*SMALL[case])
    else:
        h, b, gidx, ata, atb, valid, bd = variant_case(case)
    want_h, want_b = index_add_sum(h, b, gidx, ata, atb, valid)
    timing.reset()
    timing.enable(True)
    try:
        got_h, got_b = graph.scatter_hessian(h, b, gidx, ata, atb, valid, bd)
    finally:
        timing.enable(False)
    (rec,) = timing.records()
    timing.reset()
    e, s = gidx.shape
    assert rec.name == "graph.scatter_hessian" and rec.counts == {"entries": e * s * s}
    scale = max(float(want_h.abs().max()), 1.0)
    torch.testing.assert_close(got_h.double(), want_h, rtol=1e-5, atol=1e-6 * scale)
    torch.testing.assert_close(got_b.double(), want_b, rtol=1e-5, atol=1e-6 * scale)


@pytest.mark.parametrize("block_dim,tile", [(1, 32), (7, 28), (11, 22), (16, 32), (23, 23), (33, 33),
                                            (39, 39), (64, 64), (70, 64)])
def test_tile_width_follows_the_block(block_dim, tile):
    """The kernel's tile: the keyframe block, or as many whole blocks as fit
    in 32, at most 64."""
    assert graph.tile_width(block_dim) == tile


def test_tile_width_refuses_an_empty_block():
    with pytest.raises(ValueError):
        graph.tile_width(0)
