"""The least time of the lookups' work (ids, strings hashed on the device,
the distinct rows, the pooled output; counts/model.py) over the device time
of the hand kernels that do it (K1, K2, X1, X2 and their variants, as
counts/kernels/ names them), in the traced window."""

from recbench.readers import roofline_pct


def read(run):
    return roofline_pct(run, "serve", ("lookup", "hash"), "lookup")
