"""Finds the benchmark's parts by name, each in a file of its own:

    benchmark/configs/<name>.json     a model configuration
    benchmark/workloads/<name>.json   a cell: configuration, driver, traffic
    benchmark/drivers/<kind>.py       a driver (``run(ctx) -> Result``)
    benchmark/metrics/<name>.py       a per-layer metric's reader; a metric
                                      named <family>.<suffix> without a file
                                      of its own is read by <family>.py

Which metrics a cell reports is data, read from BENCHMARK.json at the root
of the checkout: its end-to-end metrics and the per-layer metrics that list
the cell (or, listing no cells, move one of its end-to-end metrics). A
later change adds a configuration, a cell or a metric by adding files and
entries. An unknown name raises."""
from __future__ import annotations

import functools
import glob
import importlib
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
READER_KEYS = ("LAYER", "UNIT", "SOURCE", "read")


def _json(kind: str, name: str) -> dict:
    path = os.path.join(HERE, kind, f"{name}.json")
    if os.path.sep in name or not os.path.isfile(path):
        raise KeyError(f"no {kind[:-1]} named {name!r} ({path})")
    with open(path) as f:
        data = json.load(f)
    data["name"] = name
    return data


def config(name: str) -> dict:
    return _json("configs", name)


def workload(name: str) -> dict:
    return _json("workloads", name)


def driver(kind: str):
    path = os.path.join(HERE, "drivers", f"{kind}.py")
    if not os.path.isfile(path):
        raise KeyError(f"no driver named {kind!r} ({path})")
    return importlib.import_module(f"benchmark.drivers.{kind}").run


def reader_file(name: str) -> str:
    """The reader file of per-layer metric `name`: metrics/<name>.py, else
    metrics/<family>.py for a name <family>.<suffix>."""
    for stem in (name, name.split(".")[0]):
        path = os.path.join(HERE, "metrics", f"{stem}.py")
        if os.path.sep not in name and os.path.isfile(path):
            return path
    raise KeyError(f"no metric named {name!r} (no reader in {os.path.join(HERE, 'metrics')})")


def metric(name: str):
    """The reader module of per-layer metric `name`."""
    mod = _reader(reader_file(name))
    missing = [k for k in READER_KEYS if not hasattr(mod, k)]
    if missing:
        raise ValueError(f"metric {name!r} lacks {missing}")
    return mod


@functools.cache
def _reader(path: str):
    stem = os.path.basename(path)[:-3]
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader_names() -> list:
    """The stems of the reader files under metrics/."""
    return sorted(os.path.basename(p)[:-3] for p in glob.glob(os.path.join(HERE, "metrics", "*.py")))


def benchmark_json(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _lists(entry: dict, workload_name: str, default: bool) -> bool:
    return workload_name in entry["workloads"] if "workloads" in entry else default


def end_to_end_of(workload_name: str, bench: dict | None = None) -> list | None:
    """The names of the cell's end-to-end metrics in BENCHMARK.json, or None
    for a cell that BENCHMARK.json does not hold (one run by hand)."""
    bench = benchmark_json() if bench is None else bench
    if workload_name not in {w["name"] for w in bench["workloads"]}:
        return None
    return [m["name"] for m in bench["end_to_end"] if _lists(m, workload_name, True)]


def metrics_of(workload_name: str, bench: dict | None = None) -> dict:
    """{name: (reader, unit)} of the cell's per-layer metrics in
    BENCHMARK.json: those that list the cell, and those that list no cells
    and move one of its end-to-end metrics."""
    bench = benchmark_json() if bench is None else bench
    e2e = end_to_end_of(workload_name, bench) or []
    return {m["name"]: (metric(m["name"]), m["unit"]) for m in bench["per_layer"]
            if _lists(m, workload_name, m["moves"] in e2e)}
