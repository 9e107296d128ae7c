"""The traced window's forwards times the least time one forward could
take (its operations at f32's peak or its bytes at the memory's, the
larger; counts/model.py), over the window."""

from recbench.readers import mfu_pct


def read(run):
    return mfu_pct(run, "serve", "forward")
