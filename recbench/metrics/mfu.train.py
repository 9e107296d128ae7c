"""The traced window's steps times the least time one training step could
take (forward, backward and optimizer; counts/model.py), over the
window."""

from recbench.readers import mfu_pct


def read(run):
    return mfu_pct(run, "train", "step")
