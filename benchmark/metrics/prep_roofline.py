"""The prep kernel's share (%) of its roofline in the full-graph step: the
prep's least time at the step's shapes (prep_bound: its outputs written
once and the distinct source keyframes' rows read once, at the card's
memory rate; at most every keyframe of the step is a source) over its
device time per call in the traced sub-window. The trace is read only when
it holds one ``photo_prep_points`` launch for every LM iteration the solver
reported and every launch is the instantiation for the step's code size
(its name carries the code width: ``photo_prep_points<32>`` at CS = 32);
a program whose kernel names carry no width reads nothing."""

from benchmark import prep_bound


def read(ctx):
    traced, shapes = ctx.get("traced"), ctx.get("shapes")
    if traced is None or shapes is None or "peaks" not in ctx:
        return None
    launches = traced.kernels("photo_prep_points")
    if not launches or len(launches) != ctx.get("traced_iters"):
        return None
    want = prep_bound.code_width(shapes["cs"])
    if any(prep_bound.instantiation(e["name"]) != want for e in launches):
        return None
    device_ms = sum(float(e["dur"]) for e in launches) * 1e-3 / len(launches)
    sources = min(shapes["num_kf"], shapes["e_photo"])
    bound_ms = prep_bound.prep_bound(shapes["e_photo"], shapes["levels"], shapes["c"], shapes["n"],
                                     shapes["cs"], sources, ctx["peaks"][0])[0]
    return 100.0 * bound_ms / device_ms
