"""Edge-partitioned bundle adjustment across the ranks of a process group
(port of sage_slam_tpu/parallel/sharded_ba.py).

The JAX package shards the factor-graph edge tables over a mesh axis
("e") and runs the LM loop inside shard_map: each device linearizes its
local edges, one psum reduces the partial (H, b, error) to the replicated
global system, which every device solves identically. Here the mesh is a
torch.distributed process group and every rank runs the same program on
its own device:

* ``mesh.shape["e"]`` is the group's size, ``axis_index("e")`` the rank,
  ``psum`` an ``all_reduce`` of H in place and one of (b, error) packed
  together (none in a group of one);
* the window and the priors are replicated on every rank; each rank holds
  its contiguous block of the padded edge tables (``shard_problem``);
* the priors are counted once: they are gated to rank 0's partial.

The JAX package wraps each step in a builder (``make_sharded_step``) so
that it can be jitted once and called many times; without jit the builder
adds nothing, so ``sharded_run_ba`` runs the step itself and no
``make_sharded_step`` is kept (sharded_store likewise).

Every rank must take the same accept decision, or the ranks would stop
meeting at the same collective. They do: the all-reduced error and system
are the same bits on every rank, and the same solve of the same H on the
same kind of device gives the same step (tests hold the ranks' variables
bit-equal).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from ..convert import to_device
from ..geometry.camera import CameraPyramid
from ..solver import ba, graph
from ..solver.graph import Variables

AXIS = "e"


class Mesh(NamedTuple):
    """Where JAX takes a mesh over axis "e": a process group (None: the
    default group) and this rank's device."""

    group: object
    device: torch.device

    @property
    def size(self) -> int:
        return dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        return dist.get_rank(self.group)

    def all_reduce(self, *tensors: torch.Tensor):
        """Sum each tensor over the group -> the sums. A group of one
        returns the tensors as they are; a single tensor is reduced in
        place; several are packed into one buffer for one collective."""
        if self.size == 1:
            return list(tensors)
        if len(tensors) == 1:
            t = tensors[0].contiguous()
            dist.all_reduce(t, group=self.group)
            return [t]
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat, group=self.group)
        out, start = [], 0
        for t in tensors:
            out.append(flat[start : start + t.numel()].reshape(t.shape))
            start += t.numel()
        return out


def pad_rows(x: torch.Tensor, axis: int, target: int) -> torch.Tensor:
    """x padded with zero rows along ``axis`` to ``target`` rows."""
    pad = target - x.shape[axis]
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def pad_edges(e: ba.EdgeTable, multiple: int) -> ba.EdgeTable:
    """Pad an edge table with valid=0 rows so its length divides
    ``multiple`` (the group's size)."""
    target = -(-e.i0.shape[0] // multiple) * multiple
    if target == e.i0.shape[0]:
        return e
    return type(e)(*(pad_rows(x, 0, target) for x in e))


# a reprojection table pads as any edge table: its per-edge match arrays
# ride along, and the padding rows have valid=0
pad_reproj_edges = pad_edges


def empty_reproj_edges(n: int, m: int, dtype, device) -> ba.ReprojEdgeTable:
    """An all-invalid reprojection table of ``n`` edges (one per rank), so
    every rank's program has the same factor types."""
    homo = torch.zeros((n, m, 3), dtype=dtype, device=device)
    homo[..., 2] = 1.0
    z = lambda *s: torch.zeros(s, dtype=dtype, device=device)  # noqa: E731
    zi = lambda *s: torch.zeros(s, dtype=torch.int64, device=device)  # noqa: E731
    return ba.ReprojEdgeTable(zi(n), zi(n), z(n), zi(n, m), homo, z(n, m, 2), z(n, m), z(n))


def _block(table, mesh: Mesh):
    """This rank's contiguous block of a table padded to the group's size."""
    rows = table.i0.shape[0] // mesh.size
    lo = mesh.rank * rows
    return type(table)(*(x[lo : lo + rows].to(mesh.device) for x in table))


def shard_problem(problem: ba.BAProblem, mesh: Mesh, reproj_matches: int = 8) -> ba.BAProblem:
    """This rank's problem: the window and priors on its device (replicated),
    its block of each padded edge table. All three factor families are
    edge-sharded, so the sharded step optimizes the same cost as the
    single-device one. A missing or empty reprojection table becomes an
    all-invalid table of one edge per rank."""
    n = mesh.size
    re = problem.reproj_edges
    if re is None or re.i0.shape[0] == 0:
        m = re.loc1d_0.shape[1] if re is not None else reproj_matches
        re = empty_reproj_edges(n, m, problem.window.bias_flat.dtype, mesh.device)
    else:
        re = pad_reproj_edges(re, n)
    return ba.BAProblem(
        window=to_device(problem.window, mesh.device),
        photo_edges=_block(pad_edges(problem.photo_edges, n), mesh),
        geo_edges=_block(pad_edges(problem.geo_edges, n), mesh),
        priors=to_device(problem.priors, mesh.device),
        reproj_edges=_block(re, mesh),
    )


def gate_priors(priors: ba.PriorTable, mesh: Mesh) -> ba.PriorTable:
    """Priors counted once across the group: kept on rank 0 only."""
    gate = 1.0 if mesh.rank == 0 else 0.0
    return priors._replace(
        code_valid=priors.code_valid * gate,
        scale_valid=priors.scale_valid * gate,
        pose_valid=priors.pose_valid * gate,
    )


def lm_all_reduced(variables: Variables, problem: ba.BAProblem, cam_pyr: CameraPyramid, cfg,
                   update_mask: torch.Tensor, mesh: Mesh, max_iters: int, use_conv: bool,
                   solver: str = "dense"):
    """graph.lm_loop over this rank's problem, with (H, b, error) summed
    over the group -> (variables, error, iterations, converged)."""

    def linearize_fn(v):
        h, b, err = ba.linearize(v, problem, cam_pyr, cfg)
        (h,) = mesh.all_reduce(h)  # in place: H is by far the largest
        return (h, *mesh.all_reduce(b, err))

    def error_fn(v):
        return mesh.all_reduce(ba.total_error(v, problem, cam_pyr, cfg))[0]

    return graph.lm_loop(
        variables, linearize_fn, error_fn, update_mask, max_iters,
        init_damp=cfg.gn_init_damp, min_damp=cfg.gn_min_damp, max_damp=cfg.gn_max_damp,
        damp_dec=cfg.gn_damp_dec_factor, damp_inc=cfg.gn_damp_inc_factor,
        conv_fn=ba.relin_conv(cfg) if use_conv else None, solver=solver,
    )


def sharded_run_ba(variables: Variables, problem: ba.BAProblem, cam_pyr: CameraPyramid, cfg,
                   update_mask: torch.Tensor, mesh: Mesh, max_iters: int = 4,
                   use_conv: bool = False):
    """The LM loop with edge-sharded linearization on a problem from
    shard_problem -> (variables, error, iterations, converged), the same
    on every rank. ``use_conv`` enables run_ba's relinearization-threshold
    early exit. The solve is dense, as in the JAX package's sharded step."""
    if problem.reproj_edges is None:
        raise ValueError("sharded_run_ba needs shard_problem() first (it makes the "
                         "all-invalid reprojection table of a graph without one)")
    dev = mesh.device
    local = ba.prepare_problem(problem._replace(priors=gate_priors(problem.priors, mesh)), cam_pyr)
    return lm_all_reduced(to_device(variables, dev), local, cam_pyr, cfg, update_mask.to(dev),
                          mesh, max_iters, use_conv)


def variables_out(v: Variables) -> dict:
    """A rank's variables as CPU tensors, for launch.spawn's results."""
    return {"rot": v.pose.rot.cpu(), "trans": v.pose.trans.cpu(), "code": v.code.cpu(),
            "scale": v.scale.cpu()}


def run_rank(mesh: Mesh, *jobs):
    """launch.spawn's body for whole problems: each job (variables,
    problem, cam_pyr, cfg, update_mask, max_iters, use_conv), on the CPU,
    is moved to this rank's device, sharded and solved -> per job its
    variables, error, iterations, K1's launches and this rank's
    photometric edge count."""
    from ..ops.photo_reduce import photo_reduce

    out = []
    for variables, problem, cam_pyr, cfg, update_mask, max_iters, use_conv in jobs:
        local = shard_problem(problem, mesh)
        launches = photo_reduce.launches
        v, err, iters, conv = sharded_run_ba(
            to_device(variables, mesh.device), local, cam_pyr, cfg, update_mask.to(mesh.device), mesh,
            max_iters, use_conv)
        out.append(dict(variables_out(v), error=err.cpu(), iterations=iters, converged=conv,
                        launches=photo_reduce.launches - launches,
                        photo_edges=local.photo_edges.i0.shape[0]))
    return out


def dryrun_problem(device, k: int = 4, seed: int = 0):
    """The JAX dryrun's tiny problem (K keyframes of 16x16, CS=FS=4, two
    levels, 32 samples, all ordered pairs as edges, two reprojection
    edges) -> (variables, problem, cam_pyr); numpy draws from ``seed``."""
    import numpy as np

    from .. import synthetic
    from ..geometry.interp import locations_1d_to_2d
    from ..geometry.se3 import se3_exp

    h = w = 16
    cs, fs, levels, n = 4, 4, 2, 32
    rng = np.random.default_rng(seed)
    cam, pyr = synthetic._camera(h, w, levels)
    feat = rng.standard_normal((fs, h, w)).astype(np.float32) * 0.3
    window = synthetic._window(rng, feat, k, h, w, cs, levels, n, cam, pyr, device)
    pairs = [(a, b) for a in range(k) for b in range(k) if a != b]
    edges = synthetic._edges([a for a, _ in pairs], [b for _, b in pairs], device)
    m = 8
    loc, homo = window.loc1d[0, :m], window.homo[0, :m]
    x1, y1 = locations_1d_to_2d(loc, cam.width)
    matched = torch.stack([x1, y1], dim=-1)
    reproj = ba.ReprojEdgeTable(
        i0=torch.tensor([0, 1], device=device), i1=torch.tensor([1, 0], device=device),
        valid=torch.ones(2, device=device), loc1d_0=loc[None].repeat(2, 1),
        homo_0=homo[None].repeat(2, 1, 1), matched_2d_1=matched[None].repeat(2, 1, 1),
        match_valid=torch.ones((2, m), device=device), weight=torch.ones(2, device=device),
    )
    problem = ba.BAProblem(window, edges, edges, synthetic._priors(k, device), reproj)
    taus = np.zeros((k, 6), np.float32)
    taus[1:] = rng.standard_normal((k - 1, 6)).astype(np.float32) * 0.01
    variables = Variables(se3_exp(torch.from_numpy(taus).to(device)),
                          torch.zeros((k, cs), device=device), torch.ones(k, device=device))
    return variables, problem, pyr


def _dryrun_rank(mesh: Mesh):
    from ..config import MapperConfig

    variables, problem, pyr = dryrun_problem(mesh.device)
    k = variables.num_kf
    v, err, iters, _ = sharded_run_ba(variables, shard_problem(problem, mesh), pyr,
                                      MapperConfig(), torch.ones(k), mesh, max_iters=2)
    if not bool(torch.isfinite(err)):
        raise RuntimeError("sharded BA produced a non-finite error")
    return {"error": float(err), "iterations": iters, "trans": v.pose.trans.cpu(),
            "device": str(mesh.device), "backend": dist.get_backend(mesh.group)}


def dryrun(n_ranks: int, devices=None, backend=None, workdir=None):
    """Run ONE edge-sharded BA step (2 LM iterations) on tiny shapes over
    ``n_ranks`` spawned ranks -> each rank's result. The ranks go on one
    card each unless ``devices`` says otherwise (launch.spawn)."""
    from .launch import spawn

    return spawn(_dryrun_rank, n_ranks, devices=devices, backend=backend, workdir=workdir)
