"""Kernel, copy and set launches per LM iteration inside the program's
``ba.run_ba`` spans in the traced sub-window (benchmark/spans.py; None
where its trace cannot be trusted or the program has no such spans)."""

from benchmark import spans


def read(ctx):
    a = spans.attribution(ctx)
    return None if a is None else a.launches("ba.run_ba") / a.iters
