"""Share (%) of the traced sub-window of full-graph LM steps in which no
operation ran on the device: 100 x (1 - union of the device operations'
intervals / the sub-window)."""


def read(ctx):
    traced = ctx.get("traced")
    if traced is None or traced.window_s <= 0:
        return None
    return 100.0 * (1.0 - traced.busy_s / traced.window_s)
