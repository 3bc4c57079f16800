"""Published peaks of the card, and the least time of the photometric reduce
(K1) and the FLOPs of one LM iteration, counted from shapes.

The peaks are NVIDIA's data-sheet figures (dense, no sparsity) at the full
power limit; a card run below it reads lower shares, so every run prints
the card's power limit beside its numbers. ``k1_bound`` is a frozen copy of
the repo's ``chip_smoke.reduce_bound``, taken from the reduce's input
shapes instead of its tensors.
"""

from __future__ import annotations

# card name -> (memory bytes/s, FP32 FLOP/s outside the tensor cores)
PEAKS = (
    ("H100 PCIe", 2.0e12, 51e12),
    ("H100 NVL", 3.9e12, 60e12),
    ("H100", 3.35e12, 67e12),  # SXM (HBM3)
    ("H200", 4.8e12, 67e12),
)


def peaks_for(name: str):
    """(bytes/s, FP32 FLOP/s) of the card named ``name``; raises for a card
    the table does not list, so no share is stated against a wrong peak."""
    for key, bw, flops in PEAKS:
        if key in name:
            return bw, flops
    raise KeyError(f"no published peaks for card {name!r}")


def k1_bound(e: int, levels: int, c: int, n: int, dim: int, peak_bw: float, peak_flops: float):
    """K1's least time for E edges, L levels, C feature channels, N points
    and a block of ``dim`` variables: the larger of its bytes (each float32
    input read once: fgs [E, L, 3C, N], f0 [E, L, C, N], gate [E, N],
    kx and ky [E, dim, N]; each output written once: the padded sums
    ata, atb, err, n_inl) over the memory rate and its FP32 operations over
    the peak rate -> (bound_ms, "bytes" | "operations", in_bytes,
    out_bytes, flops)."""
    in_bytes = 4 * (e * levels * 3 * c * n + e * levels * c * n + e * n + 2 * e * dim * n)
    out_bytes = 4 * (e * dim * dim + e * dim + 2 * e)
    npairs = dim * (dim + 1) // 2
    flops = e * n * (levels * c * 13 + npairs * 10 + dim * 4 + 2)
    t_bytes, t_ops = (in_bytes + out_bytes) / peak_bw, flops / peak_flops
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations",
            in_bytes, out_bytes, flops)


def lm_iteration_flops(e_photo: int, e_geo: int, levels: int, c: int, n: int, cs: int,
                       num_kf: int) -> float:
    """FP32 operations of one LM iteration of the full-graph BA, from
    shapes: the photometric reduce as ``k1_bound`` counts it (dim 13+CS),
    the geometric reduce (per point a (14+2CS)-wide Gram, 2 operations per
    entry of its upper triangle, and its gradient), and the Cholesky of the
    (7+CS)K-wide system (D^3/3) with its two triangular solves (2 D^2)."""
    dim_p = 13 + cs
    photo = k1_bound(e_photo, levels, c, n, dim_p, 1.0, 1.0)[4]
    dim_g = 14 + 2 * cs
    geo = e_geo * n * (dim_g * (dim_g + 1) + 2 * dim_g)
    d = (7 + cs) * num_kf
    return float(photo + geo + d ** 3 / 3.0 + 2.0 * d * d)
