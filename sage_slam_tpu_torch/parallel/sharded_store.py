"""Keyframe-sharded mapping step (port of
sage_slam_tpu/parallel/sharded_store.py).

sharded_ba shards the edge tables but replicates the window on every
rank. Here the keyframe axis of the store's big tables is block-sharded
over the group: rank r keeps rows [r*kloc, (r+1)*kloc) of every table
(the capacity padded to a multiple of the group's size). A mapping step
reassembles only the window-incident rows (the compact id set of
solver/ba.compact_problem_keyframes): each rank contributes the rows it
owns, zeros elsewhere, and one all_reduce sums the contributions into the
compact window on every rank. The LM loop then runs edge-sharded as in
sharded_ba. Per-rank bytes of the store tables are 1/n of the replicated
design (store_bytes_per_device). As in sharded_ba, the JAX package's
step builder (``make_sharded_window_step``, there for jit) is not kept:
``sharded_window_run_ba`` runs the step itself.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..convert import to_device
from ..geometry.camera import CameraPyramid
from ..solver import ba
from ..solver.graph import Variables
from . import sharded_ba
from .sharded_ba import Mesh

AXIS = sharded_ba.AXIS

# WindowData fields and the axis their keyframe dimension lives on; the
# window's FrameTables go through FrameTables.map, which passes each table
# with its own.
_KF_AXIS = {
    "loc1d": 0,
    "homo": 0,
    "bias_flat": 0,
    "jac_flat": 0,
    "feat_pyr": 1,
    "grad_pyr": 2,
    "src_feats": 0,
    "avg_sq_bias": 0,
}


def _own_block(x: torch.Tensor, axis: int, kp: int, mesh: Mesh) -> torch.Tensor:
    """This rank's block of rows along ``axis``, padded to kp rows in all,
    as a tensor of its own on the rank's device."""
    kloc = kp // mesh.size
    block = sharded_ba.pad_rows(x, axis, kp).narrow(axis, mesh.rank * kloc, kloc)
    return block.to(mesh.device, copy=True).contiguous()


def shard_window(window: ba.WindowData, mesh: Mesh) -> ba.WindowData:
    """This rank's block of every per-keyframe table (the keyframe capacity
    padded up to a multiple of the group's size); the mask is replicated."""
    n = mesh.size
    k = window.bias_flat.shape[0]
    kp = -(-k // n) * n
    own = lambda t, axis: _own_block(t, axis, kp, mesh)  # noqa: E731
    updates = {name: own(getattr(window, name), axis) for name, axis in _KF_AXIS.items()}
    updates["mask_flat"] = window.mask_flat.to(mesh.device)
    updates["tables"] = None if window.tables is None else window.tables.map(own)
    return window._replace(**updates)


def store_bytes_per_device(window: ba.WindowData, n_devices: int) -> dict:
    """Replicated against keyframe-sharded bytes per rank of the window
    tables (the store's device footprint)."""
    total = 0 if window.tables is None else window.tables.nbytes()
    for name in _KF_AXIS:
        val = getattr(window, name)
        total += val.numel() * val.element_size()
    return {"replicated_bytes": total, "sharded_bytes_per_device": -(-total // n_devices)}


def _owned_rows(local: torch.Tensor, ids: torch.Tensor, axis: int, mesh: Mesh) -> torch.Tensor:
    """Rows ``ids`` of a block-sharded table as this rank contributes them:
    the rows it owns, zeros for the others."""
    kloc = local.shape[axis]
    base = mesh.rank * kloc
    rows = local.index_select(axis, (ids - base).clamp(0, kloc - 1))
    own = (ids >= base) & (ids < base + kloc)
    shape = [1] * rows.dim()
    shape[axis] = own.shape[0]
    return torch.where(own.reshape(shape), rows, torch.zeros_like(rows))


def gather_window(window: ba.WindowData, ids: torch.Tensor, mesh: Mesh) -> ba.WindowData:
    """The boundary exchange: the compact window of rows ``ids`` from the
    ranks' blocks, summed by one all_reduce per dtype. Its traffic is the
    incident rows, independent of the store's size."""
    parts = []

    def owned(t, axis):
        parts.append(_owned_rows(t, ids, axis, mesh))
        return parts[-1]

    fields = {name: owned(getattr(window, name), axis) for name, axis in _KF_AXIS.items()}
    tables = None if window.tables is None else window.tables.map(owned)
    # one collective per dtype, in the same order on every rank (a set's
    # order of dtypes follows their addresses, which differ between ranks)
    for dtype in sorted({t.dtype for t in parts}, key=str):
        at = [i for i, t in enumerate(parts) if t.dtype == dtype]
        for i, summed in zip(at, mesh.all_reduce(*(parts[i] for i in at))):
            parts[i] = summed
    summed = iter(parts)
    fields = {name: next(summed) for name in fields}
    if tables is not None:
        tables = tables.map(lambda t, axis: next(summed))
    return window._replace(**fields, tables=tables)


def sharded_window_run_ba(variables: Variables, window_sharded: ba.WindowData,
                          photo_edges: ba.EdgeTable, geo_edges: ba.EdgeTable, reproj_edges,
                          priors_compact: ba.PriorTable, ids: torch.Tensor,
                          pad_valid: torch.Tensor, update_mask: torch.Tensor,
                          cam_pyr: CameraPyramid, cfg, mesh: Mesh, max_iters: int = 4,
                          use_conv: bool = False):
    """The keyframe-sharded compact mapping step -> (variables, error,
    iterations, converged): gathers the incident rows ``ids`` from this
    rank's window blocks, builds the compact problem, runs the
    edge-sharded LM and writes the compact rows back into the full
    variables. ``priors_compact``, ``update_mask`` and ``pad_valid`` are
    sized to the compact id set; the edge tables are whole, in compact
    indices, and are padded to a multiple of the group's size and cut to
    this rank's block here."""
    n, dev = mesh.size, mesh.device
    pe = sharded_ba._block(sharded_ba.pad_edges(photo_edges, n), mesh)
    ge = sharded_ba._block(sharded_ba.pad_edges(geo_edges, n), mesh)
    if reproj_edges is None or reproj_edges.i0.shape[0] == 0:
        m = reproj_edges.loc1d_0.shape[1] if reproj_edges is not None else 8
        reproj_edges = sharded_ba.empty_reproj_edges(n, m, variables.scale.dtype, dev)
    else:
        reproj_edges = sharded_ba.pad_reproj_edges(reproj_edges, n)
    re = sharded_ba._block(reproj_edges, mesh)
    v = to_device(variables, dev)
    ids, pad_valid, umask = ids.to(dev), pad_valid.to(dev), update_mask.to(dev)
    compact = gather_window(window_sharded, ids, mesh)
    pr = priors_compact._replace(
        code_valid=priors_compact.code_valid * pad_valid,
        scale_valid=priors_compact.scale_valid * pad_valid,
        pose_valid=priors_compact.pose_valid * pad_valid,
    )
    problem = ba.BAProblem(compact, pe, ge, sharded_ba.gate_priors(to_device(pr, dev), mesh), re)
    v_c = Variables(type(v.pose)(v.pose.rot[ids], v.pose.trans[ids]), v.code[ids], v.scale[ids])
    vs, err, iters, conv = sharded_ba.lm_all_reduced(
        v_c, problem, cam_pyr, cfg, umask, mesh, max_iters, use_conv,
        ba.resolve_solver(cfg, v_c.num_kf))
    rot, trans = v.pose.rot.clone(), v.pose.trans.clone()
    code, scale = v.code.clone(), v.scale.clone()
    rot[ids], trans[ids], code[ids], scale[ids] = vs.pose.rot, vs.pose.trans, vs.code, vs.scale
    return Variables(type(v.pose)(rot, trans), code, scale), err, iters, conv


def run_rank(mesh: Mesh, *jobs):
    """launch.spawn's body: each job (variables, a prepared full window,
    photo_edges, geo_edges, reproj_edges, compact priors, ids, pad_valid,
    update_mask, cam_pyr, cfg, max_iters), on the CPU, is sharded over the
    group and solved -> per job its variables, error, iterations, K1's
    launches, this rank's shard sizes (elements) and bytes of the store
    tables beside store_bytes_per_device's."""
    from ..ops.photo_reduce import photo_reduce

    out = []
    for (variables, window, pe, ge, re, priors_c, ids, pad_valid, umask, cam_pyr, cfg,
         max_iters) in jobs:
        win = shard_window(window, mesh)
        local_bytes = store_bytes_per_device(win, 1)["replicated_bytes"]
        launches = photo_reduce.launches
        dev = mesh.device
        v, err, iters, conv = sharded_window_run_ba(
            to_device(variables, dev), win, to_device(pe, dev), to_device(ge, dev),
            to_device(re, dev), to_device(priors_c, dev), ids.to(dev),
            pad_valid.to(dev), umask.to(dev), cam_pyr, cfg, mesh, max_iters)
        out.append(dict(
            sharded_ba.variables_out(v), error=err.cpu(), iterations=iters, converged=conv,
            launches=photo_reduce.launches - launches, local_bytes=local_bytes,
            accounting=store_bytes_per_device(window, mesh.size),
            shard_numel={"feat_pyr": win.feat_pyr.numel(), "grad_pyr": win.grad_pyr.numel(),
                         "packed_fg": win.tables.packed_fg.numel(),
                         "bias_flat": win.bias_flat.numel()},
        ))
    return out


def _dryrun_rank(mesh: Mesh):
    from ..config import MapperConfig

    variables, problem, pyr = sharded_ba.dryrun_problem(mesh.device, k=8)
    problem = ba.prepare_problem(problem, pyr)
    win = shard_window(problem.window, mesh)
    # the compact set: keyframes 2..5 with a chain of edges
    ids = [2, 3, 4, 5]
    pairs = [(0, 1), (1, 0), (1, 2), (2, 1), (2, 3), (3, 2)]
    dev = mesh.device
    edges = ba.EdgeTable(torch.tensor([a for a, _ in pairs], device=dev),
                         torch.tensor([b for _, b in pairs], device=dev),
                         torch.ones(len(pairs), device=dev))
    sel = torch.tensor(ids, device=dev)
    pr = problem.priors
    priors_c = ba.PriorTable(pr.code_valid[sel], pr.scale_valid[sel], pr.scale_init[sel],
                             pr.pose_valid[sel],
                             type(pr.pose_target)(pr.pose_target.rot[sel], pr.pose_target.trans[sel]))
    v, err, iters, _ = sharded_window_run_ba(
        variables, win, edges, edges, None, priors_c, sel, torch.ones(4, device=dev),
        torch.ones(4, device=dev), pyr, MapperConfig(), mesh, max_iters=2,
    )
    if not bool(torch.isfinite(err)):
        raise RuntimeError("sharded-store BA produced a non-finite error")
    return {"error": float(err), "iterations": iters, "trans": v.pose.trans.cpu(),
            "device": str(mesh.device), "backend": dist.get_backend(mesh.group)}


def dryrun(n_ranks: int, devices=None, backend=None, workdir=None):
    """Run ONE keyframe-sharded compact mapping step (2 LM iterations) on
    tiny shapes over ``n_ranks`` spawned ranks -> each rank's result. The
    ranks go on one card each unless ``devices`` says otherwise
    (launch.spawn)."""
    from .launch import spawn

    return spawn(_dryrun_rank, n_ranks, devices=devices, backend=backend, workdir=workdir)
