"""A tiny size of every cell for the CPU tests: the configuration's widths
cut, a few thousand points a scene, short windows."""
import copy
import tempfile
import time

import torch

from benchmark.harness import registry, runner

MODEL = dict(num_planes=(8, 16), d_model=32, num_heads=1, hidden_dim=32, num_layers=1,
             max_points=8192, voxel_capacity=16384, max_superpoints=256, query_thr=200,
             max_gts=16)
POINTS = {"scannet": [3000, 6000], "multiscan": [3000, 4000], "3rscan": [3000, 4000],
          "arkitscenes": [3000, 4000]}


def workload(name: str) -> dict:
    wl = copy.deepcopy(registry.workload(name))
    wl["raw_points"] = {k: POINTS[k] for k in wl["raw_points"]}
    if wl["driver"] == "eval":
        wl["files"] = {k: 3 for k in wl["files"]}
        wl["scenes"] = {k: 6 for k in wl["scenes"]}
    if wl["driver"] == "train_loader":
        wl["scenes"] = {k: 8 for k in wl["scenes"]}
    return wl


def run(name: str, seed: int = 5, trace: bool = False, seconds: float = 2.0, **model) -> dict:
    """One tiny run of cell `name` on the CPU: the result line."""
    torch.set_num_threads(2)
    wl = workload(name)
    with tempfile.TemporaryDirectory() as d:
        ctx = context(wl, seed, d, trace=trace, seconds=seconds, **model)
        return runner.execute(ctx, registry.driver(wl["driver"]))


def context(wl: dict, seed: int, scratch: str, trace=False, seconds=2.0, **model):
    return runner.Context(workload=wl, config=registry.config(wl["config"]), seed=seed,
                          seconds=seconds, trace=trace, device=torch.device("cpu"),
                          t_start=time.perf_counter(), scratch=scratch,
                          model_overrides=dict(MODEL, **model))
