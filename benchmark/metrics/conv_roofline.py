"""The subm convs' bound seconds (K1 in a forward; K1, K1', K2 in a training
step; harness/counts.py::conv_bound_s) over the device seconds of their
kernels, taken by name from the trace, in %."""
from benchmark.harness import readers

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"


def read(record):
    return readers.roofline(record, "conv")
