"""The consumer's mean wait in next(TrainLoader) per window step, by the
harness's clock around the call."""
from benchmark.harness import readers

LAYER = "loader"
UNIT = "ms"
SOURCE = "host_clock"


def read(record):
    return readers.mean_ms(record.get("loader_waits_s"))
