"""Share of the Segment Anything evaluate loop's idle device time that no
span of the program below its root ``evaluate_movie`` covers (device trace
against the program's spans)."""

from cardbench.harness.program_spans import idle_unattributed_pct


def read(ctx):
    return idle_unattributed_pct(ctx)
