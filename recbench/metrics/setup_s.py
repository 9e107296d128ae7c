"""Seconds from the start of the process to the first timed request or
step: loading the kernels, making the weights and the traffic, building
the program and capturing its graphs."""


def read(run):
    return run.setup_s
