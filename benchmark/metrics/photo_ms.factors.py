"""Device ms per LM iteration of the operations launched inside the
program's ``lin.photo`` spans and outside their ``graph.scatter_hessian``
spans (the photometric factors' prep, K1, normalisation and slot indices)
in the traced sub-window (benchmark/spans.py; None where its trace cannot
be trusted or the program has no such spans)."""

from benchmark import spans


def read(ctx):
    a = spans.attribution(ctx)
    if a is None:
        return None
    return a.device_ms("lin.photo", outside=("graph.scatter_hessian",)) / a.iters
