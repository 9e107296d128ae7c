"""Mean milliseconds of one step's ``Engine.prepare``: host prep."""

from recbench.readers import span_mean_ms


def read(run):
    return span_mean_ms(run, "train", "prepare")
