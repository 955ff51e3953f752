"""The training step's model operations (counted from each batch's shapes,
harness/counts.py::model_flops) over the traced slice's wall time x 989
TFLOP/s (bf16 peak), in %."""
from benchmark.harness import readers

LAYER = "step / device"
UNIT = "%"
SOURCE = "host_clock"


def read(record):
    return readers.mfu(record) if record.get("train") else None
