"""Median over the window's batches of the loader workers' seconds per batch
(pipeline + collate + pack + stage), from the program's TrainLoader.times
(WorkerTimes)."""
import statistics

LAYER = "loader"
UNIT = "s"
SOURCE = "program_span"


def read(record):
    return statistics.median(record["worker_batch_s"]) if record.get("worker_batch_s") else None
