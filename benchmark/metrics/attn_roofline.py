"""The decoder attention's bound seconds (K3 in a forward; K3, K3-dkv, K3-dq
in a training step; harness/counts.py::attn_bound_s) over the device
seconds of their kernels, taken by name from the trace, in %."""
from benchmark.harness import readers

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"


def read(record):
    return readers.roofline(record, "attn")
