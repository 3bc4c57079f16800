"""Factor-graph Gauss-Newton/LM over the keyframe window (port of
sage_slam_tpu/solver/graph.py).

Per-keyframe variable block (dim 7 + CS):
  [0:6] pose tangent (left-multiplicative, [trans, rot]),
  [6:6+CS] depth code, [6+CS] scale.

Edge blocks are scatter-added into one dense block Hessian over the window
(on the card by one hand-written kernel, csrc/hessian_assembly.cu) and
solved with a damped Cholesky, either whole ("dense") or by first
eliminating every keyframe's code and scale block ("schur").
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..geometry.se3 import SE3, retract
from ..utils import timing
from .psd import psd_bump


class Variables(NamedTuple):
    """SoA keyframe state: pose [K], code [K, CS], scale [K]."""

    pose: SE3  # rot [K,3,3], trans [K,3]
    code: torch.Tensor  # [K, CS]
    scale: torch.Tensor  # [K]

    @property
    def num_kf(self) -> int:
        return self.scale.shape[0]

    @property
    def code_size(self) -> int:
        return self.code.shape[-1]

    @property
    def block_dim(self) -> int:
        return 7 + self.code_size

    def apply_delta(self, delta: torch.Tensor, update_mask: torch.Tensor) -> "Variables":
        """delta [K, block_dim]; update_mask [K] gates frozen keyframes, or
        [K, block_dim] gates individual components."""
        cs = self.code_size
        m = expand_mask(update_mask, self.block_dim).to(delta.dtype)
        new_pose = retract(self.pose, delta[:, :6] * m[:, :6])
        new_code = self.code + delta[:, 6 : 6 + cs] * m[:, 6 : 6 + cs]
        new_scale = self.scale + delta[:, 6 + cs] * m[:, 6 + cs]
        return Variables(new_pose, new_code, new_scale)


def expand_mask(update_mask: torch.Tensor, block_dim: int) -> torch.Tensor:
    """Normalize a per-keyframe [K] or per-component [K, block_dim]
    update mask to [K, block_dim]."""
    if update_mask.dim() == 1:
        return update_mask[:, None].expand(update_mask.shape[0], block_dim)
    return update_mask


def slot_indices(kf_idx: torch.Tensor, block_dim: int, sel: torch.Tensor) -> torch.Tensor:
    """Global tangent indices [..., S] for the slots ``sel`` [S] of the
    keyframes ``kf_idx`` [...]."""
    return kf_idx[..., None] * block_dim + sel


@timing.span("graph.scatter_hessian")
def scatter_hessian(
    h: torch.Tensor,  # [D, D]
    b: torch.Tensor,  # [D]
    gidx: torch.Tensor,  # [E, S] global indices per edge
    ata: torch.Tensor,  # [E, S, S]
    atb: torch.Tensor,  # [E, S]
    valid: torch.Tensor,  # [E] 0/1
    block_dim: int,  # the keyframe block width: the kernel's tiles follow it
):
    """Accumulate per-edge Hessian blocks -> (h, b): each edge adds
    valid² · ata into H at (gidx, gidx) and valid · atb into b at gidx;
    slots of one edge that repeat a global index are all summed, an index
    outside [0, D) places nothing, and an edge with valid 0 is skipped.
    The ``entries`` count of the span is E·S·S, the entries placed.

    On CUDA tensors one hand-written kernel does it (csrc/hessian_assembly.cu,
    ``_scatter_kernel``): it updates h and b in place and returns them,
    with a fixed summation order and no atomics, so two calls on the same
    inputs give bitwise-equal results, and H comes out exactly symmetric
    when h and every block are. On the CPU the plain version,
    ``scatter_hessian_ref``, returns new tensors. Callers use the pair
    returned."""
    e, s = gidx.shape
    timing.count("entries", e * s * s)
    if h.device.type == "cuda":
        return _scatter_kernel(h, b, gidx, ata, atb, valid, block_dim)
    return scatter_hessian_ref(h, b, gidx, ata, atb, valid)


def scatter_hessian_ref(h, b, gidx, ata, atb, valid):
    """The plain assembly: H += P^T (A P), b += P^T atb, with the one-hot
    selection P [E*S, D] scaled by valid, as float32 matmuls, as in the JAX
    package. Each output entry sums the same products as a scatter-add; the
    order of that sum differs from the JAX package's, so comparisons use
    float32-roundoff tolerances. A NaN in an edge's block spreads over the
    rows and columns it meets (0 · NaN), where the kernel keeps it to its
    own entries."""
    d = h.shape[-1]
    e, s = gidx.shape
    cols = torch.arange(d, dtype=gidx.dtype, device=gidx.device)
    p = (gidx[..., None] == cols).to(h.dtype) * valid.to(h.dtype)[:, None, None]
    pf = p.reshape(e * s, d)
    bmat = ata @ p  # [E, S, D]
    h = h + pf.T @ bmat.reshape(e * s, d)
    b = b + pf.T @ atb.reshape(e * s)
    return h, b


MAX_TILE = 64  # csrc/hessian_assembly.cu kMaxTile


def tile_width(block_dim: int) -> int:
    """The kernel's tile width for keyframe blocks of ``block_dim``: the
    block itself, or as many whole blocks as fit in 32 for narrow ones, at
    most MAX_TILE, so an edge between two keyframes touches 2 x 2 tiles."""
    if block_dim < 1:
        raise ValueError(f"block_dim={block_dim}; expected at least 1")
    if block_dim <= 32:
        return block_dim * (32 // block_dim)
    return min(block_dim, MAX_TILE)


@functools.cache
def _library() -> ctypes.CDLL:
    """The built assembly library with its C signatures declared."""
    from .._build import load_library

    lib = load_library("assembly")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.assembly_launch.argtypes = ([ptr, ptr, ptr, i64, i64, ptr, i64, i64, i64, ptr, i64, i64,
                                     ptr, i64, ptr, i32, i32, i64, i32, ptr])
    lib.assembly_launch.restype = i32
    lib.assembly_error_string.argtypes = [i32]
    lib.assembly_error_string.restype = ctypes.c_char_p
    return lib


def _scatter_kernel(h, b, gidx, ata, atb, valid, block_dim):
    """The card's assembly: two launches (the plan and the tile pass), no
    host read; checked first. Each call adds 1 to the ``assembly.kernel``
    count of the span open around it and to ``_scatter_kernel.calls``; an
    empty edge set launches nothing."""
    dev = h.device
    if dev.index != torch.cuda.current_device():  # the C launcher uses the current card
        with torch.cuda.device(dev):
            return _scatter_kernel(h, b, gidx, ata, atb, valid, block_dim)
    d = h.shape[-1]
    e, s = gidx.shape
    tile = tile_width(block_dim)
    named = {"h": h, "b": b, "gidx": gidx, "ata": ata, "atb": atb, "valid": valid}
    for name, t in named.items():
        if t.device != dev:
            raise ValueError(f"hessian assembly kernel: {name} is on {t.device}, h on {dev}")
        want = torch.int64 if name == "gidx" else torch.float32
        if t.dtype != want:
            raise TypeError(f"hessian assembly kernel: {name} is {t.dtype}, expected {want}")
    if h.shape != (d, d) or b.shape != (d,) or ata.shape != (e, s, s) or atb.shape != (e, s) \
            or valid.shape != (e,):
        raise ValueError(f"hessian assembly kernel: shapes h {tuple(h.shape)}, b {tuple(b.shape)}, "
                         f"gidx {tuple(gidx.shape)}, ata {tuple(ata.shape)}, atb {tuple(atb.shape)}, "
                         f"valid {tuple(valid.shape)}")
    if not (h.is_contiguous() and b.is_contiguous()):
        raise ValueError("hessian assembly kernel: h and b are updated in place and must be contiguous")
    if torch.is_grad_enabled() and any(t.requires_grad for t in named.values()):
        raise ValueError("hessian assembly kernel: an input carries an autograd graph; the kernel "
                         "has no backward")
    if e == 0 or s == 0:
        return h, b
    rows = torch.empty(-(-d // tile) * -(-e // 32), dtype=torch.int32, device=dev)
    lib = _library()
    status = lib.assembly_launch(
        h.data_ptr(), b.data_ptr(), gidx.data_ptr(), *gidx.stride(), ata.data_ptr(), *ata.stride(),
        atb.data_ptr(), *atb.stride(), valid.data_ptr(), valid.stride(0), rows.data_ptr(), e, s, d,
        tile, torch.cuda.current_stream(dev).cuda_stream,
    )
    if status != 0:
        raise RuntimeError(f"hessian assembly kernel launch failed: CUDA error {status} "
                           f"({lib.assembly_error_string(status).decode()})")
    _scatter_kernel.calls += 1
    timing.count("assembly.kernel", 1)
    return h, b


_scatter_kernel.calls = 0


def empty_system(num_kf: int, block_dim: int, dtype=torch.float32, device=None):
    dim = num_kf * block_dim
    return (
        torch.zeros((dim, dim), dtype=dtype, device=device),
        torch.zeros((dim,), dtype=dtype, device=device),
    )


def psd_correct(ata: torch.Tensor) -> torch.Tensor:
    """Per-edge PSD correction before assembly: symmetrize + Gerschgorin-
    scaled diagonal bump (solver.psd.psd_bump)."""
    return psd_bump(ata)


def schur_solve(h: torch.Tensor, b: torch.Tensor, num_kf: int, block_dim: int):
    """Solve H delta = b by eliminating every keyframe's (code, scale)
    block first -> (delta [D], ok). H is the damped, masked SPD system
    (frozen rows are identity).

    Per keyframe, the pose dims p (6) and the code+scale dims c
    (block_dim - 6) partition the system:

        [App Apc] [dp]   [bp]
        [Acp Acc] [dc] = [bc]

    dc is eliminated through a Cholesky of Acc, the reduced 6K pose
    system S = App - Apc Acc^-1 Acp is solved densely, then dc is
    recovered. Acc is the FULL cross-coupled block: geometric edges couple
    the codes of two keyframes, so it is not block-diagonal, and the
    result equals the dense solve up to float32 factorization roundoff.
    ``ok`` is False when either factorization failed (JAX's NaNs).

    Spans: ``solve.factor`` holds the partition, both factorizations and
    the elimination products; ``solve.tri`` the pose solve and the code
    and scale recovery."""
    dev = h.device
    with timing.span("solve.factor"):
        kf = torch.arange(num_kf, device=dev)[:, None] * block_dim
        pose_idx = (kf + torch.arange(6, device=dev)).reshape(-1)
        cs_idx = (kf + torch.arange(6, block_dim, device=dev)).reshape(-1)
        h_p = h[pose_idx]
        app = h_p[:, pose_idx]  # [6K, 6K]
        apc = h_p[:, cs_idx]  # [6K, (bd-6)K]
        acc = h[cs_idx][:, cs_idx]
        bp, bc = b[pose_idx], b[cs_idx]
        u_cc, info_cc = torch.linalg.cholesky_ex(acc, upper=True)
        x = torch.cholesky_solve(apc.T.contiguous(), u_cc, upper=True)  # Acc^-1 Acp
        y = torch.cholesky_solve(bc[:, None], u_cc, upper=True)[:, 0]
        s = app - apc @ x
        rhs = bp - (apc @ y[:, None])[:, 0]
        u_s, info_s = torch.linalg.cholesky_ex(s, upper=True)
    with timing.span("solve.tri"):
        dp = torch.cholesky_solve(rhs[:, None], u_s, upper=True)[:, 0]
        dc = y - (x @ dp[:, None])[:, 0]
        delta = torch.zeros_like(b)
        delta[pose_idx] = dp
        delta[cs_idx] = dc
        return delta, (info_cc == 0) & (info_s == 0)


def _damped_solve(h, b, damping: float, min_damp: float, free, solver: str = "dense",
                  num_kf: int = 0, block_dim: int = 0):
    """Solve (H + damping diag(H) + min_damp I) delta = b on the free
    components (frozen rows/cols become identity with zero rhs).

    JAX's cho_factor turns a failed factorization into NaNs, which the
    isfinite mask then zeroes. torch.linalg.cholesky raises instead and
    cholesky_ex returns a partial factor that is not NaN, so the factor's
    ``info`` decides: delta is 0 whenever a factorization failed. The
    upper factor is used, as cho_factor's default reads the upper
    triangle.

    Every operation lies in one of three spans, so their device time adds
    up to the caller's ``lm.solve``: ``solve.damp`` (the damped, masked
    system and its rhs), ``solve.factor`` (the factorization) and
    ``solve.tri`` (the triangular solves and the ``ok``/finite masking)."""
    dim = h.shape[-1]
    with timing.span("solve.damp"):
        eye = torch.eye(dim, dtype=h.dtype, device=h.device)
        h_damped = h + torch.diag(damping * torch.diagonal(h)) + min_damp * eye
        h_masked = h_damped * free[:, None] * free[None, :] + torch.diag(1.0 - free)
        b_masked = b * free
    if solver == "schur":
        delta, ok = schur_solve(h_masked, b_masked, num_kf, block_dim)
        with timing.span("solve.tri"):
            return _kept(delta, ok), b_masked
    with timing.span("solve.factor"):
        u, info = torch.linalg.cholesky_ex(h_masked, upper=True)
    with timing.span("solve.tri"):
        delta = torch.cholesky_solve(b_masked[:, None], u, upper=True)[:, 0]
        return _kept(delta, info == 0), b_masked


def _kept(delta, ok):
    """delta where the factorization succeeded (``ok``) and finite, else 0."""
    delta = torch.where(ok, delta, torch.zeros_like(delta))
    return torch.where(torch.isfinite(delta), delta, torch.zeros_like(delta))


def lm_loop(
    variables: Variables,
    linearize_fn,  # vars -> (H [D,D], b [D], error scalar)
    error_fn,  # vars -> error scalar (used ONCE, for the final candidate)
    update_mask: torch.Tensor,  # [K] per-keyframe or [K, bd] per-component
    max_iters: int,
    init_damp: float = 1e-4,
    min_damp: float = 1e-6,
    max_damp: float = 1e2,
    damp_dec: float = 10.0,
    damp_inc: float = 10.0,
    min_error_dec: float = 0.0,
    conv_fn=None,  # (delta [K, bd], grad [K, bd]) -> bool; on accepted step
    solver: str = "dense",  # "dense" | "schur" (schur_solve above)
):
    """Deferred-acceptance damped GN (Levenberg-Marquardt) ->
    (variables, error, iterations, converged).

    One iteration = linearize the CANDIDATE -> accept/reject against the
    last accepted error -> damped solve from the accepted linearization
    (a reject re-solves the stored (H, b) under higher damping) -> retract
    the next candidate. After the loop, one error_fn pass decides the last
    candidate, which no linearization evaluated.

    The JAX package runs this in one lax.while_loop; here it is a Python
    loop whose accept decision is read on the host once per iteration.
    The damping is kept as a float32 scalar, so the stop test
    ``damping <= max_damp`` sees the same float32 values as in JAX."""
    if solver not in ("dense", "schur"):
        raise ValueError(f"solver={solver!r}; expected 'dense' or 'schur'")
    k = variables.num_kf
    bd = variables.block_dim
    dtype = variables.scale.dtype
    device = variables.scale.device
    f32 = np.float32
    max_damp32 = f32(max_damp)
    with timing.span("lm.init"):
        mask2d = expand_mask(update_mask, bd).to(dtype)
        free = mask2d.reshape(-1)
        error = torch.tensor(float("inf"), dtype=dtype, device=device)
        h, b = empty_system(k, bd, dtype, device)

    accepted = variables
    candidate = variables
    damping = f32(init_damp)
    iteration = 0
    converged = False
    while iteration < max_iters and damping <= max_damp32 and not converged:
        with timing.span("lm.iter"):
            h_c, b_c, err_c = linearize_fn(candidate)
            # first iteration always accepts: the accepted error starts at +inf
            with timing.span("lm.accept"):
                accept = bool(err_c < error - min_error_dec)
                timing.count("lm.host_reads")
            timing.count("lm.accepted" if accept else "lm.rejected")
            if accept:
                accepted, error, h, b = candidate, err_c, h_c, b_c
                damping = max(damping / f32(damp_dec), f32(min_damp))
            else:
                damping = damping * f32(damp_inc)
            with timing.span("lm.solve"):
                delta, b_masked = _damped_solve(h, b, float(damping), min_damp, free, solver, k, bd)
            with timing.span("lm.retract"):
                delta = delta.reshape(k, bd)
                candidate = accepted.apply_delta(delta, update_mask)
            # gate on accept: a post-reject delta is small because the damping
            # is high, not because the graph converged
            if accept and conv_fn is not None:
                with timing.span("lm.accept"):
                    converged = bool(conv_fn(delta * mask2d, b_masked.reshape(k, bd)))
                    timing.count("lm.host_reads")
            iteration += 1
    with timing.span("ba.total_error"):
        err_c = error_fn(candidate)
        better = bool(err_c < error - min_error_dec)
        timing.count("lm.host_reads")
    if better:
        return candidate, err_c, iteration, converged
    return accepted, error, iteration, converged
