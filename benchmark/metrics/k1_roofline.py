"""K1's share (%) of its roofline in the full-graph step: the reduce's least
time at the step's shapes (peaks.k1_bound: bytes at the card's memory rate
or FP32 operations at its peak, whichever is larger) over K1's device time
per call in the traced sub-window (``photo_reduce_split`` plus
``photo_reduce_combine``). The trace is read only when it holds one
``photo_reduce_split`` launch for every LM iteration the solver reported."""

from benchmark import peaks


def read(ctx):
    traced, shapes = ctx.get("traced"), ctx.get("shapes")
    if traced is None or shapes is None or "peaks" not in ctx:
        return None
    splits = traced.kernels("photo_reduce_split")
    if not splits or len(splits) != ctx.get("traced_iters"):
        return None
    device_ms = sum(float(e["dur"]) for e in traced.kernels("photo_reduce_")) * 1e-3 / len(splits)
    bw, flops = ctx["peaks"]
    bound_ms = peaks.k1_bound(shapes["e_photo"], shapes["levels"], shapes["c"], shapes["n"],
                              shapes["dim"], bw, flops)[0]
    return 100.0 * bound_ms / device_ms
