"""Share of the traced sub-window in which no kernel, copy or fill ran on
the device (the union of their intervals)."""

from portbench.harness.readers import idle_pct


def read(run):
    return idle_pct(run, "infer")
