"""The 95th percentile of the latency of every request answered in the
window, from the submit to the scores on the host; a failed request counts
as missing."""


def read(run):
    if run.kind != "serve" or run.trace is not None:
        return None
    return run.e2e["p95_ms"]
