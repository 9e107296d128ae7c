"""The least time of the lookups' backward (the cotangents and ids read,
the distinct rows' gradients written; counts/model.py) over the device
time of the hand kernels that do it (K3a, K3b, X1b and Part, the partition
they launch, as counts/kernels/ names them), in the traced window."""

from recbench.readers import roofline_pct


def read(run):
    return roofline_pct(run, "train", ("lookup_grad",), "lookup_grad")
