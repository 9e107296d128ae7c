"""The share of the traced window in which no operation ran on the
device."""

from recbench.readers import idle_pct


def read(run):
    return idle_pct(run, "serve")
