"""PSD correction of per-factor Hessian blocks (port of
sage_slam_tpu/solver/psd.py).

The AtA blocks are Gram matrices, PSD up to float32 roundoff. The hot path
symmetrizes and adds a fixed relative diagonal bump (psd_bump); the exact
projection (nearest_psd) is kept for tests and offline use.
"""

from __future__ import annotations

import torch


def nearest_psd(mat: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Exact nearest-PSD projection of [..., D, D] (batched eigh clamp)."""
    sym = 0.5 * (mat + mat.transpose(-1, -2))
    w, v = torch.linalg.eigh(sym)
    w = torch.clamp(w, min=eps)
    return torch.einsum("...ik,...k,...jk->...ij", v, w, v)


def psd_bump(mat: torch.Tensor, rel: float = 2e-4) -> torch.Tensor:
    """Symmetrize [..., D, D] and add rel * c on the diagonal, with c the
    Gerschgorin bound max_i sum_j |a_ij|. Zero blocks stay zero."""
    return _bump(0.5 * (mat + mat.transpose(-1, -2)), rel)


def _bump(sym: torch.Tensor, rel: float) -> torch.Tensor:
    d = sym.shape[-1]
    c = torch.amax(torch.sum(torch.abs(sym), dim=-1), dim=-1)
    eye = torch.eye(d, dtype=sym.dtype, device=sym.device)
    return sym + (rel * c)[..., None, None] * eye


def psd_bump_symmetric(mat: torch.Tensor, rel: float = 2e-4) -> torch.Tensor:
    """psd_bump for blocks that are already bit-symmetric (no transpose)."""
    return _bump(mat, rel)
