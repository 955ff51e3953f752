"""The eval loop's mean wait per group for the EvalLoader, from evaluate's
eval_stats records (wait_s), over the window's groups."""
from benchmark.harness import readers

LAYER = "loader"
UNIT = "ms"
SOURCE = "program_span"


def read(record):
    return readers.mean_ms(record.get("eval_waits_s"))
