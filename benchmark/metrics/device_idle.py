"""The device's idle share of the traced slice (window steps 3-6 of a
training cell, the first window pass of an eval cell): 1 minus the union of
device intervals over its wall time, in %."""
from benchmark.harness import readers

LAYER = "step / device"
UNIT = "%"
SOURCE = "device_trace"


def read(record):
    return readers.idle_share(record)
