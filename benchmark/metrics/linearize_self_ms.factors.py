"""Device ms per LM iteration of the operations launched inside the
program's ``ba.linearize`` spans and outside their ``graph.scatter_hessian``
spans (the factors' gathers, K1, Jacobians and priors) in the traced
sub-window (benchmark/spans.py; None where its trace cannot be trusted or
the program has no such spans)."""

from benchmark import spans


def read(ctx):
    a = spans.attribution(ctx)
    if a is None:
        return None
    return a.device_ms("ba.linearize", outside=("graph.scatter_hessian",)) / a.iters
