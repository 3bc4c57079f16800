"""Start the ranks of a process group and collect what each returns.

``spawn(fn, nprocs, args)`` runs ``fn(mesh, *args)`` in ``nprocs`` fresh
processes (``torch.multiprocessing.spawn``), rank r on ``devices[r]``
(by default ``cuda:r``, one card per rank: like every entry point of the
port, it runs on the card unless the caller names the CPU, and raises
without CUDA), joined in one process group through a ``file://``
rendezvous: no TCP port, which parallel runs would fight over. Every
collective of the group times out after ``collective_timeout_s`` and the
whole launch after ``timeout_s``, so a rank that raises or stalls cannot
leave the others blocked: the first failure terminates every rank and is
raised here.

Each rank imports ``fn``'s module afresh, so ``fn`` must be a module-level
function of a module that imports only torch and this package.

``one_rank(device)`` makes this process a group of one (NCCL on a CUDA
device, gloo on the CPU) for as long as the ``with`` block lasts.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..device import resolve_device
from .sharded_ba import Mesh


def rank_devices(nprocs: int, devices=None) -> list:
    """Each rank's device, checked -> a list of ``nprocs`` device strings.
    None puts rank r on ``cuda:r`` and raises without CUDA or with fewer
    cards than ranks; an explicit list (``["cpu"] * n`` in tests, two
    ranks on ``cuda:0``) goes through device.resolve_device."""
    if devices is None:
        resolve_device(None)
        if nprocs > torch.cuda.device_count():
            raise ValueError(f"{nprocs} ranks, one per card, but {torch.cuda.device_count()} "
                             "card(s); pass devices= to share one")
        devices = [f"cuda:{r}" for r in range(nprocs)]
    if len(devices) != nprocs:
        raise ValueError(f"{len(devices)} devices for {nprocs} ranks")
    return [str(resolve_device(d)) for d in devices]


def default_backend(devices) -> str:
    """NCCL when every rank has a card of its own, gloo otherwise (the
    CPU, or ranks sharing a card, which NCCL refuses)."""
    devs = [torch.device(d) for d in devices]
    own_cards = all(d.type == "cuda" for d in devs) and len(set(devs)) == len(devs)
    return "nccl" if own_cards else "gloo"


def _rank_main(rank, fn, world, init_file, backend, devices, args, out_dir, threads,
               collective_timeout_s):
    torch.set_num_threads(threads)
    device = resolve_device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=f"file://{init_file}", world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=collective_timeout_s),
    )
    try:
        out = fn(Mesh(None, device), *args)
        if out is not None:
            torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _fresh_rendezvous(workdir, prefix: str) -> str:
    workdir = workdir if workdir is not None else tempfile.mkdtemp(prefix=prefix)
    os.makedirs(workdir, exist_ok=True)
    init_file = os.path.join(os.path.abspath(workdir), "rendezvous")
    if os.path.exists(init_file):
        os.remove(init_file)
    return init_file


def spawn(fn, nprocs: int, args=(), devices=None, backend=None, workdir=None,
          timeout_s: float = 300.0, collective_timeout_s: float = 60.0, threads: int = 1):
    """Run ``fn(mesh, *args)`` on ``nprocs`` ranks -> the list of what each
    rank returned (saved with torch.save: tensors, numbers, strings and
    containers of them). ``devices`` and ``backend`` default as
    rank_devices and default_backend say. ``workdir`` holds the
    rendezvous file and the results (a new temporary directory when
    None)."""
    devices = rank_devices(nprocs, devices)
    backend = backend or default_backend(devices)
    init_file = _fresh_rendezvous(workdir, "spawn")
    out_dir = os.path.dirname(init_file)
    ctx = mp.spawn(
        _rank_main,
        args=(fn, nprocs, init_file, backend, devices, tuple(args), out_dir, threads,
              collective_timeout_s),
        nprocs=nprocs, join=False,
    )
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=max(0.1, min(5.0, deadline - time.monotonic()))):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{nprocs} ranks did not finish within {timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
    outs = []
    for rank in range(nprocs):
        path = os.path.join(out_dir, f"rank{rank}.pt")
        outs.append(torch.load(path) if os.path.exists(path) else None)
    return outs


@contextlib.contextmanager
def one_rank(device=None, backend=None, workdir=None, collective_timeout_s: float = 60.0):
    """This process as a group of one on ``device`` (the current card by
    default, raising without CUDA) -> its Mesh. ``backend`` defaults to
    NCCL on a CUDA device and gloo on the CPU. Without a default group
    one is made and destroyed on leaving the block; in a process that
    already has one, a new group holding this rank alone is made beside
    it and destroyed on leaving."""
    device = resolve_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    timeout = datetime.timedelta(seconds=collective_timeout_s)
    if dist.is_initialized():
        group = dist.new_group([dist.get_rank()], timeout=timeout, backend=backend,
                               use_local_synchronization=True)
        try:
            yield Mesh(group, device)
        finally:
            dist.destroy_process_group(group)
        return
    init_file = _fresh_rendezvous(workdir, "one_rank")
    dist.init_process_group(backend, init_method=f"file://{init_file}", world_size=1, rank=0,
                            timeout=timeout)
    try:
        yield Mesh(None, device)
    finally:
        dist.destroy_process_group()
