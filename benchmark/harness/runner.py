"""One run of one cell: find the workload, its configuration and its driver
by name, run the driver on the card, and print the result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Without a CUDA card, or with fewer cards than the cell asks for, the run
fails and prints no result. The last line of standard output is the result:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics), ``device``,
optionally ``breakdown``, and last ``checks``: each number that decided
``correct`` beside its limit, which also end standard error.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import shutil
import sys
import tempfile
from typing import Callable

import torch

from . import registry

# Top-level module names that no run may load: the JAX package, JAX, flax.
FORBIDDEN = ("jax", "jaxlib", "flax", "unidet3d_tpu")


@dataclasses.dataclass
class Context:
    """What a driver gets: the run's arguments, the cell's and its
    configuration's data, the device, and where to write its scenes."""
    workload: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float  # time.perf_counter() at process start
    scratch: str  # a fresh directory under TMPDIR, removed after the run
    model_overrides: dict = dataclasses.field(default_factory=dict)  # tests only


@dataclasses.dataclass
class Result:
    """What a driver returns. `end_to_end`: {name: (value, unit)}; `record`:
    what the per-layer readers read (traced runs); `checks`: [(name, value,
    limit)], each correct when value <= limit; `memory_peak_bytes` read
    before the reference ran."""
    end_to_end: dict
    record: dict
    checks: list
    attempted: int
    failed: int
    memory_peak_bytes: int
    trace: dict | None = None


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules() -> list:
    """Loaded modules whose whole top-level name is one of FORBIDDEN."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def correct_of(checks) -> bool:
    return all(math.isfinite(v) and v <= limit for _, v, limit in checks)


def result_line(res: Result, trace: bool, per_layer: dict, device: torch.device) -> dict:
    if trace:
        metrics = per_layer
    else:
        metrics = {k: {"value": v, "unit": u} for k, (v, u) in res.end_to_end.items()}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(res.memory_peak_bytes)}
    line = {"correct": correct_of(res.checks), "attempted": int(res.attempted),
            "failed": int(res.failed), "metrics": metrics, "device": dev}
    if trace and res.trace is not None:
        dev["busy_s"] = res.trace["busy_s"]
        dev["window_s"] = res.trace["window_s"]
        line["breakdown"] = res.trace["breakdown"]
    line["checks"] = {name: {"value": v, "limit": limit} for name, v, limit in res.checks}
    return line


def read_per_layer(workload_name: str, res: Result) -> dict:
    """Every per-layer metric of this cell whose reader finds something to
    read."""
    out = {}
    for name, (reader, unit) in registry.metrics_of(workload_name).items():
        value = reader.read(res.record)
        if value is not None:
            out[name] = {"value": value, "unit": unit}
    return out


def end_to_end(workload_name: str, res: Result) -> Result:
    """The result with the end-to-end metrics that BENCHMARK.json gives this
    cell (all the driver's, for a cell that it does not hold)."""
    names = registry.end_to_end_of(workload_name)
    if names is None:
        return res
    missing = set(names) - set(res.end_to_end)
    if missing:
        raise KeyError(f"the driver gives no {sorted(missing)} for {workload_name}")
    return dataclasses.replace(res, end_to_end={k: res.end_to_end[k] for k in names})


def execute(ctx: Context, run: Callable[[Context], Result]) -> dict:
    """Runs a driver and returns the result line (no card check: the tests
    call this on the CPU)."""
    res = end_to_end(ctx.workload["name"], run(ctx))
    per_layer = read_per_layer(ctx.workload["name"], res) if ctx.trace else {}
    return result_line(res, ctx.trace, per_layer, ctx.device)


def main(argv, t_start: float) -> int:
    args = parse_args(argv)
    workload = registry.workload(args.workload)
    config = registry.config(workload["config"])
    chips = int(workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA card(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    scratch = tempfile.mkdtemp(prefix="unidet3d_bench_")
    try:
        ctx = Context(workload=workload, config=config, seed=args.seed,
                      seconds=args.seconds, trace=bool(args.trace), device=device,
                      t_start=t_start, scratch=scratch)
        line = execute(ctx, registry.driver(workload["driver"]))
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    found = forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


def setup_environment(root: str) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths; no
    library the port uses may load JAX."""
    build = os.path.join(root, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(build, "nv_compute_cache")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
