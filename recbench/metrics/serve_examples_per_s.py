"""Candidate rows answered in the window, over the window's seconds."""


def read(run):
    if run.kind != "serve" or run.trace is not None:
        return None
    return run.e2e["examples"] / run.e2e["window_s"]
