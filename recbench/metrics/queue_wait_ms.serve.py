"""Mean milliseconds from a request's submit to the start of its
``Engine.prepare``: the wait in the serving pipeline's queue."""

from recbench.readers import span_mean_ms


def read(run):
    return span_mean_ms(run, "serve", "queue_wait")
