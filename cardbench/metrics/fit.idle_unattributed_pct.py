"""Share of the measured ``fit`` call's idle device time that no span of the
program below its root ``fit`` covers (device trace against the program's
spans): what the spans leave unexplained of the idle time."""

from cardbench.harness.program_spans import idle_unattributed_pct


def read(ctx):
    return idle_unattributed_pct(ctx)
