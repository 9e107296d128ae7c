"""Mean host milliseconds of one ``Engine.dispatch``: staging, the copy
into the program's inputs and its replay's launch."""

from recbench.readers import span_mean_ms


def read(run):
    return span_mean_ms(run, "serve", "dispatch")
