"""Host ms per LM iteration inside the program's ``lm.accept`` spans, where
the host blocks on the device to read the LM's accept decision, in the
traced sub-window (benchmark/spans.py; None where its trace cannot be
trusted or the program has no such spans)."""

from benchmark import spans


def read(ctx):
    a = spans.attribution(ctx)
    return None if a is None else a.host_ms("lm.accept") / a.iters
