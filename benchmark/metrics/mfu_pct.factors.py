"""The full-graph LM step's share (%) of the card's FP32 peak over the
window: the operations of one LM iteration counted from the step's shapes
(peaks.lm_iteration_flops: the photometric and geometric reduces and the
dense Cholesky with its solves), times the LM iterations the solver
reported, over the window's seconds and the published FP32 rate (the
configuration computes in float32 with TF32 off)."""

from benchmark import peaks


def read(ctx):
    shapes = ctx.get("shapes")
    if shapes is None or "peaks" not in ctx or not ctx.get("lm_iters"):
        return None
    per_iter = peaks.lm_iteration_flops(shapes["e_photo"], shapes["e_geo"], shapes["levels"],
                                        shapes["c"], shapes["n"], shapes["cs"], shapes["num_kf"])
    return 100.0 * per_iter * ctx["lm_iters"] / ctx["window_s"] / ctx["peaks"][1]
