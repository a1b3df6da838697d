"""What the per-layer metrics read of the measured program's own counters
(``deepcalcium_torch.utils.profiling.count``), which the program records,
as its spans, only while the traced window's profiler runs.

Every function takes a reader's context and returns None where there is
nothing to read: an untraced run, or a program that records no counters
(one older than the counter primitive, whose ``profiling`` has no
``counted``)."""


def window_counts(ctx):
    """The program's counts taken in the traced window, or None."""
    if ctx.trace is None:
        return None
    from deepcalcium_torch.utils import profiling

    counted = getattr(profiling, "counted", None)
    if counted is None:
        return None
    return counted(ctx.trace.t0, ctx.trace.t1) or None


def total(ctx, name):
    """The sum of the counts ``name`` in the window, or None."""
    got = [c.value for c in window_counts(ctx) or [] if c.name == name]
    return sum(got) if got else None
