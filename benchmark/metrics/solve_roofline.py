"""The factorization's share (%) of its roofline in the full-graph step:
its least time at the step's width (solve_bound: D^3/3 FP32 operations at
the card's peak or the D x D system read and its factor written at the
memory rate, whichever is longer; D = num_kf x (7 + CS)) over the device
ms launched in the program's ``solve.factor`` spans per LM iteration in the
traced sub-window (benchmark/spans.py; None where its trace cannot be
trusted or the program has no such spans). The bound holds on the dense
and the Schur path alike (solve_bound says why)."""

from benchmark import solve_bound, spans


def read(ctx):
    shapes = ctx.get("shapes")
    if shapes is None or "peaks" not in ctx:
        return None
    a = spans.attribution(ctx)
    if a is None:
        return None
    device_ms = a.device_ms("solve.factor") / a.iters
    if device_ms <= 0:
        return None
    d = shapes["num_kf"] * (7 + shapes["cs"])
    return 100.0 * solve_bound.solve_bound(d, *ctx["peaks"])[0] / device_ms
