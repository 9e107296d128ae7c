"""Examples of every training step of the window, over the time from the
window's start to the end of its last step (each step ends in its loss
read on the host)."""


def read(run):
    if run.kind != "train" or run.trace is not None:
        return None
    return run.e2e["examples"] / run.e2e["window_s"]
