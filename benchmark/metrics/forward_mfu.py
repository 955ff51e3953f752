"""The eval forwards' model operations (counted from each group's shapes,
harness/counts.py::model_flops) over the traced slice's wall time x 989
TFLOP/s (bf16 peak), in %."""
from benchmark.harness import readers

LAYER = "step / device"
UNIT = "%"
SOURCE = "host_clock"


def read(record):
    return None if record.get("train", True) else readers.mfu(record)
