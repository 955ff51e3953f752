"""The harness finds its parts by name, the committed files agree with
BENCHMARK.json, and the result line has the contract's keys."""
import dataclasses
import importlib
import json
import os
import subprocess
import sys

import pytest

from benchmark.harness import registry, runner

ROOT = os.path.dirname(registry.HERE)
with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
CONFIGS = [c["name"] for c in BENCH["configs"]]
METRICS = [m["name"] for m in BENCH["per_layer"]]


@pytest.mark.parametrize("name", WORKLOADS)
def test_workload_found_by_name(name):
    wl = registry.workload(name)
    entry = next(w for w in BENCH["workloads"] if w["name"] == name)
    assert wl["config"] == entry["config"] and wl["chips"] == entry["chips"] == 1
    assert wl["why"] == entry["why"]
    assert callable(registry.driver(wl["driver"]))
    assert set(wl["limits"]) >= {"loss_gap"} or set(wl["limits"]) >= {"fwd_logits_gap"}


@pytest.mark.parametrize("name", CONFIGS)
def test_config_found_by_name_and_runs_as_written(name):
    cfg = registry.config(name)
    entry = next(c for c in BENCH["configs"] if c["name"] == name)
    assert entry["file"] == f"benchmark/configs/{name}.json"
    assert sorted(entry["reduced"]) == sorted(cfg["reduced"])
    model = importlib.import_module(cfg["experiment"]).get_config().model
    run = {k: list(v) if isinstance(v, tuple) else v
           for k, v in dataclasses.asdict(model).items()}
    assert run == cfg["model"]


@pytest.mark.parametrize("name", METRICS)
def test_metric_found_by_name_and_declared_alike(name):
    reader = registry.metric(name)
    entry = next(m for m in BENCH["per_layer"] if m["name"] == name)
    assert (reader.LAYER, reader.UNIT, reader.SOURCE) == (
        entry["layer"], entry["unit"], entry["source"])
    assert reader.read({}) is None  # nothing to read: no number


ALL_WORKLOADS = sorted(f[:-5] for f in os.listdir(os.path.join(registry.HERE, "workloads")))


@pytest.mark.parametrize("name", ALL_WORKLOADS)
def test_every_workload_file_names_its_parts(name):
    """Also the cells that BENCHMARK.json does not hold (PERF.md, Open
    questions): a later change adds them back as entries."""
    wl = registry.workload(name)
    registry.config(wl["config"])
    assert callable(registry.driver(wl["driver"]))
    assert wl["chips"] == 1 and wl["limits"]


@pytest.mark.parametrize("stem", registry.reader_names())
def test_every_reader_file_loads(stem):
    reader = registry.metric(stem)
    assert reader.read({}) is None


def test_every_config_file_is_in_benchmark_json():
    configs = sorted(f[:-5] for f in os.listdir(os.path.join(registry.HERE, "configs")))
    assert configs == sorted(CONFIGS)
    assert set(WORKLOADS) <= set(ALL_WORKLOADS)


def test_metrics_of_a_cell_come_from_benchmark_json():
    bench = {"workloads": [{"name": "a"}, {"name": "b"}],
             "end_to_end": [{"name": "rate", "workloads": ["a"]}, {"name": "setup_s"}],
             "per_layer": [{"name": "device_idle.x", "unit": "%", "moves": "rate"},
                           {"name": "conv_roofline.y", "unit": "%", "moves": "setup_s",
                            "workloads": ["b"]}]}
    assert registry.end_to_end_of("a", bench) == ["rate", "setup_s"]
    assert registry.end_to_end_of("b", bench) == ["setup_s"]
    assert registry.end_to_end_of("held-back", bench) is None
    assert list(registry.metrics_of("a", bench)) == ["device_idle.x"]
    assert list(registry.metrics_of("b", bench)) == ["conv_roofline.y"]
    assert registry.metrics_of("b", bench)["conv_roofline.y"][0] is registry.metric(
        "conv_roofline.staged")  # one reader per family


@pytest.mark.parametrize("kind", ["workload", "config", "driver", "metric"])
def test_unknown_name_fails(kind):
    with pytest.raises(KeyError):
        getattr(registry, kind)("no-such-name")


def test_each_cell_reports_what_its_metrics_move():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", WORKLOADS)


def test_result_line_has_the_contract_keys():
    res = runner.Result(end_to_end={"setup_s": (1.5, "s")}, record={},
                        checks=[("loss_gap", 0.1, 0.2)], attempted=3, failed=0,
                        memory_peak_bytes=7,
                        trace={"busy_s": 1.0, "window_s": 2.0,
                               "breakdown": {"device_ops": [], "idle_gaps": []}})
    import torch

    line = runner.result_line(res, False, {}, torch.device("cpu"))
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["metrics"] == {"setup_s": {"value": 1.5, "unit": "s"}}
    assert line["correct"] is True
    traced = runner.result_line(res, True, {"x": {"value": 1.0, "unit": "%"}},
                                torch.device("cpu"))
    assert list(traced) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                            "checks"]
    assert {"busy_s", "window_s", "memory_peak_bytes", "platform", "kind", "count"} <= set(
        traced["device"])
    failed = runner.result_line(dataclasses.replace(res, checks=[("x", 0.3, 0.2)]), False, {},
                                torch.device("cpu"))
    assert failed["correct"] is False


def test_without_a_card_the_run_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", WORKLOADS[0],
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
