"""The least time of the LM step's factorization, counted from the
system's width.

The full-graph step factors the damped system of D = K x (7 + CS) rows once
an LM iteration (the program's ``solve.factor`` span: ``cholesky_ex`` on the
dense path). Its least time is the larger of its FP32 operations at the
card's peak, D^3/3 as ``peaks.lm_iteration_flops`` counts them, and its
bytes at the memory rate: the D x D float32 system read once and its factor
written once. The triangular solves, the damping and the masking around it
lie in other spans and are not counted.

On the Schur path (``graph.schur_solve``) the span holds the Cholesky of the
m = K x (1 + CS) code and scale rows, their elimination from the p = 6K
pose rows and the pose system's Cholesky: the same block factorization in
another order. Its least count, m^3/3 + m^2 p + m p^2 + p^3/3, is D^3/3
(the program's count, 2 m^2 p + 2 m p^2 for the products, is higher), so
the bound holds there too.
"""

from __future__ import annotations


def solve_bound(d: int, peak_bw: float, peak_flops: float):
    """The factorization's least time for a D-wide system -> (bound_ms,
    "bytes" | "operations", bytes, flops)."""
    flops = d ** 3 / 3.0
    nbytes = 2 * 4 * d * d
    t_bytes, t_ops = nbytes / peak_bw, flops / peak_flops
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes > t_ops else "operations", nbytes,
            flops)
