"""Device ms per LM iteration of the operations launched inside the
program's ``graph.scatter_hessian`` spans (the one-hot Hessian assembly) in
the traced sub-window (benchmark/spans.py; None where its trace cannot be
trusted or the program has no such spans)."""

from benchmark import spans


def read(ctx):
    a = spans.attribution(ctx)
    return None if a is None else a.device_ms("graph.scatter_hessian") / a.iters
