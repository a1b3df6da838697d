"""Share of the traced window in which no operation ran on the card, over
the Segment Anything evaluate loop (device trace)."""


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
