"""The port's loaders (``unidet3d_tpu_torch/data/loader.py``) against the JAX
package's: TrainLoader batches (every PointBatch / GTBatch array and the
GridPack tables) for one seed, whatever the thread count; EvalLoader's order,
groups, n_real and bucket configs, with the JAX package's ``_bucket_cfg``
cases; worker errors raised in the consumer; CPU tensors with device="cpu";
``WorkerTimes`` are the seconds of the ``loader.*`` spans."""
import dataclasses
import os
import pickle
import threading

import numpy as np
import pytest
import torch

from tests.test_data_pipeline import make_fake_scene
from unidet3d_tpu.core.config import default_config as jax_config
from unidet3d_tpu.data import datasets as jax_datasets
from unidet3d_tpu.data import loader as jax_loader
from unidet3d_tpu.data import pipelines as jax_pipelines
from unidet3d_tpu_torch.core.config import default_config
from unidet3d_tpu_torch.data import datasets, pipelines
from unidet3d_tpu_torch.data.batcher import map_arrays
from unidet3d_tpu_torch.data.loader import (
    DeviceStager,
    EvalLoader,
    TrainLoader,
    _build,
    capacity_buckets,
    superpoint_buckets,
)
from unidet3d_tpu_torch.train import profiling

SMALL = dict(max_points=2048, voxel_capacity=2048, max_superpoints=48, max_gts=8,
             num_planes=(8, 16, 24))


def write_dataset(root, sizes, yaw=False):
    entries = [make_fake_scene(root, f"scene{i}", n=n, n_inst=4, seed=i, yaw=yaw)
               for i, n in enumerate(sizes)]
    with open(os.path.join(root, "infos.pkl"), "wb") as f:
        pickle.dump({"metainfo": {}, "data_list": entries}, f)


def make_concat(mod, pipes, roots, train=True):
    sets = [mod.IndoorDataset(root, "infos.pkl", didx,
                              pipeline=(pipes.train_pipeline(name) if train
                                        else pipes.test_pipeline(name)),
                              test_mode=not train, seed=didx)
            for didx, (name, root) in enumerate(roots)]
    return mod.ConcatDataset(sets) if train else sets[0]


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("loader")
    out = []
    for name, sizes in (("scannet", (1500, 2600, 1800)), ("multiscan", (1200, 2100))):
        root = str(base / name)
        write_dataset(root, sizes)
        out.append((name, root))
    return out


def assert_batches_equal(mine_host, ref, label):
    batch, gt, pack = mine_host
    jbatch, jgt, jpack = ref
    for mine, theirs in ((batch, jbatch), (gt, jgt)):
        for name, value in theirs._asdict().items():
            np.testing.assert_array_equal(getattr(mine, name), value,
                                          err_msg=f"{label}: {name}")
    for name in ("valid", "neighbors", "parent", "offset_code"):
        for a, b in zip(getattr(pack, name), getattr(jpack, name)):
            np.testing.assert_array_equal(a, np.asarray(b)[0], err_msg=f"{label}: {name}")
    np.testing.assert_array_equal(pack.point_inverse, jpack.point_inverse[0])


def test_train_batches_match_jax_for_any_thread_count(roots):
    ref_loader = jax_loader.TrainLoader(
        make_concat(jax_datasets, jax_pipelines, roots),
        jax_config(subm_impl="xla", **SMALL), 2, seed=3, num_threads=2)
    try:
        ref = [next(ref_loader) for _ in range(3)]
    finally:
        ref_loader.close()
    runs = {}
    for threads in (1, 3):
        loader = TrainLoader(make_concat(datasets, pipelines, roots), default_config(**SMALL),
                             2, seed=3, num_threads=threads, device="cpu")
        try:
            runs[threads] = [next(loader) for _ in range(3)]
        finally:
            loader.close()
        assert not any(t.is_alive() for t in loader._threads)
        assert len(loader.times) >= 3
    for threads, batches in runs.items():
        for n, (tb, r) in enumerate(zip(batches, ref)):
            assert_batches_equal(tb.host, r, f"{threads} threads, batch {n}")
            # The CPU "staging" yields the collated arrays as tensors.
            assert isinstance(tb.batch.points, torch.Tensor)
            assert tb.batch.points.device.type == "cpu"
            np.testing.assert_array_equal(tb.batch.points.numpy(), tb.host[0].points)
            assert tb.pack.n_valid == tb.host[2].n_valid
            assert all(isinstance(v, int) for v in tb.pack.n_valid)
    datasets_seen = {int(d) for tb in runs[1] for d in tb.host[0].dataset_ids}
    assert datasets_seen == {0, 1}


@pytest.mark.parametrize("shard", [(0, 1), (1, 2)])
def test_eval_groups_and_buckets_match_jax(tmp_path, shard):
    root = str(tmp_path / "scannet")
    write_dataset(root, (900, 3000, 1500, 2200, 600, 2900, 1200))
    cfg = dict(SMALL, max_points=16384, voxel_capacity=16384)
    shard_idx, shard_count = shard

    def groups(mod, pipes, make_loader):
        ds = mod.IndoorDataset(root, "infos.pkl", 0, pipeline=pipes.test_pipeline("scannet"),
                               test_mode=True)
        return list(make_loader(ds))

    ref = groups(jax_datasets, jax_pipelines, lambda ds: jax_loader.EvalLoader(
        ds, jax_config(subm_impl="xla", **cfg), 2, shard_idx=shard_idx,
        shard_count=shard_count, num_threads=2))
    mine = groups(datasets, pipelines, lambda ds: EvalLoader(
        ds, default_config(**cfg), 2, shard_idx=shard_idx, shard_count=shard_count,
        num_threads=3, device="cpu"))
    assert len(mine) == len(ref) > 1
    for g, (m, r) in enumerate(zip(mine, ref)):
        samples, batch, gt, pack, n_real, cfg_b = m
        rs, rbatch, rgt, rpack, rn_real, rcfg_b = r
        assert [s["scene_idx"] for s in samples] == [s["scene_idx"] for s in rs]
        assert n_real == rn_real
        assert (cfg_b.max_points, cfg_b.voxel_capacity, cfg_b.max_superpoints) == (
            rcfg_b.max_points, rcfg_b.voxel_capacity, rcfg_b.max_superpoints)
        host = tuple(map_arrays(torch.Tensor.numpy, t) for t in (batch, gt, pack))
        assert_batches_equal(host, (rbatch, rgt, rpack), f"group {g}")
    if shard == (0, 1):  # size-sorted, the last group padded by its last scene
        order = [s["scene_idx"] for m in mine for s in m[0][:m[4]]]
        assert order == [1, 5, 3, 2, 6, 0, 4]
        assert mine[-1][4] == 1
        assert len({m[5].max_points for m in mine}) >= 2


def _dummy(cfg):
    """An EvalLoader-shaped object for _bucket_cfg alone (no threads)."""
    return type("L", (), {"cfg": cfg, "buckets": capacity_buckets(cfg),
                          "_scene_level_needs": EvalLoader._scene_level_needs})()


def _jax_dummy(cfg):
    return type("L", (), {"cfg": cfg, "buckets": jax_loader.capacity_buckets(cfg),
                          "_scene_level_needs": jax_loader.EvalLoader._scene_level_needs})()


def _slab(rng, n, n_sp=None):
    pts = rng.rand(n, 3).astype(np.float32) * [4.0, 4.0, 0.2]
    s = {"points": pts}
    if n_sp is not None:
        s["sp_pts_mask"] = rng.randint(0, n_sp, size=n)
    return s


@pytest.mark.parametrize("caps", [
    dict(max_points=131072, voxel_capacity=131072, max_superpoints=48),
    dict(max_points=131072, voxel_capacity=131072, max_superpoints=3072),
    dict(max_points=196608, voxel_capacity=163840, max_superpoints=3072),
    dict(max_points=8192, voxel_capacity=8192, max_superpoints=512),
    dict(max_points=100000, voxel_capacity=90000, max_superpoints=2500),
])
def test_buckets_match_jax(caps):
    cfg, jcfg = default_config(**caps), jax_config(**caps)
    assert capacity_buckets(cfg) == jax_loader.capacity_buckets(jcfg)
    assert superpoint_buckets(cfg) == jax_loader.superpoint_buckets(jcfg)
    if caps["max_points"] == 131072 and caps["max_superpoints"] == 48:
        assert capacity_buckets(cfg) == (32768, 65536, 81920, 98304, 114688, 122880, 131072)
    if caps["max_superpoints"] == 3072:
        assert superpoint_buckets(cfg) == (1024, 2048, 3072)


@pytest.mark.parametrize("group, points_rung, sp_rung", [
    ([(92_000, None)], 98304, 48),  # ~0.7x the cap: the 3/4 rung
    ([(72_000, None)], 81920, 48),  # ~0.55x: 5/8
    ([(110_000, None)], 114688, 48),  # ~0.85x: 7/8
    ([(20_000, None), (92_000, None)], 98304, 48),  # the group's largest scene
    ([(40_000, 700)], 65536, 1024),
    ([(40_000, 1500)], 65536, 2048),
    ([(40_000, 700), (40_000, 2500)], 65536, 3072),
    ([(1000, 1)], 32768, 1024),
])
def test_bucket_cfg_cases_match_jax(group, points_rung, sp_rung):
    sp_cap = 48 if sp_rung == 48 else 3072
    caps = dict(max_points=131072, voxel_capacity=131072, max_superpoints=sp_cap)
    cfg, jcfg = default_config(**caps), jax_config(subm_impl="xla", **caps)
    rng = np.random.RandomState(0)
    samples = [_slab(rng, n, n_sp) for n, n_sp in group]
    mine = EvalLoader._bucket_cfg(_dummy(cfg), samples)
    ref = jax_loader.EvalLoader._bucket_cfg(_jax_dummy(jcfg), samples)
    assert (mine.max_points, mine.voxel_capacity, mine.max_superpoints) == (
        ref.max_points, ref.voxel_capacity, ref.max_superpoints) == (
        points_rung, points_rung, sp_rung)


def test_bucket_cfg_checks_every_level(tmp_path):
    """Sparse uniform scenes: the coarse levels' voxels, not the point count,
    pick the bucket (the JAX package's case)."""
    root = str(tmp_path / "scannet")
    write_dataset(root, (2000, 2000))
    caps = dict(max_points=32768, voxel_capacity=32768, max_superpoints=48,
                num_planes=(8, 16, 24, 32))
    ds = datasets.IndoorDataset(root, "infos.pkl", 0,
                                pipeline=pipelines.test_pipeline("scannet"), test_mode=True)
    samples = [ds[0], ds[1]]
    mine = EvalLoader._bucket_cfg(_dummy(default_config(**caps)), samples)
    ref = jax_loader.EvalLoader._bucket_cfg(
        _jax_dummy(jax_config(subm_impl="xla", **caps)), samples)
    assert mine.max_points == ref.max_points == 16384
    needs = EvalLoader._scene_level_needs(_dummy(default_config(**caps)), samples[0])
    assert needs[0] <= 2000 and needs[-1] > 1024


class _Broken:
    """A dataset whose scenes fail to load."""

    def __len__(self):
        return 4

    def get(self, idx, rng=None):
        raise ValueError(f"scene {idx} is unreadable")

    def __getitem__(self, idx):
        return self.get(idx)


def test_worker_errors_are_raised_in_the_consumer():
    loader = TrainLoader(_Broken(), default_config(**SMALL), 2, num_threads=2, device="cpu")
    try:
        with pytest.raises(RuntimeError, match="TrainLoader worker failed") as info:
            next(loader)
        assert isinstance(info.value.__cause__, ValueError)
    finally:
        loader.close(timeout=30)
    assert not any(t.is_alive() for t in loader._threads)
    with pytest.raises(RuntimeError, match="EvalLoader worker failed") as info:
        list(EvalLoader(_Broken(), default_config(**SMALL), 2, num_threads=2, device="cpu"))
    assert isinstance(info.value.__cause__, ValueError)


def test_loaders_need_cuda_unless_cpu_is_asked(roots):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    concat = make_concat(datasets, pipelines, roots)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TrainLoader(concat, default_config(**SMALL), 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EvalLoader(concat.datasets[0], default_config(**SMALL), 2)


def test_bucket_configs_keep_the_model_fields(tmp_path):
    """A bucket config differs from the loader's in capacities only."""
    root = str(tmp_path / "scannet")
    write_dataset(root, (900, 3000))
    cfg = default_config(**dict(SMALL, max_points=4096, voxel_capacity=4096))
    ds = datasets.IndoorDataset(root, "infos.pkl", 0,
                                pipeline=pipelines.test_pipeline("scannet"), test_mode=True)
    for *_, cfg_b in EvalLoader(ds, cfg, 1, num_threads=1, device="cpu"):
        changed = {f.name for f in dataclasses.fields(cfg)
                   if getattr(cfg, f.name) != getattr(cfg_b, f.name)}
        assert changed <= {"max_points", "voxel_capacity", "max_superpoints"}


def test_train_loader_stress_many_threads(roots):
    """More workers than cores and a short switch interval: the batch stream
    is still batch n = f(seed, n), in order, none lost or repeated."""
    import sys

    def stream(threads, n=8):
        loader = TrainLoader(make_concat(datasets, pipelines, roots), default_config(**SMALL),
                             2, seed=11, num_threads=threads, prefetch=1, device="cpu")
        try:
            return [next(loader).host for _ in range(n)]
        finally:
            loader.close(timeout=30)

    ref = stream(1)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = stream(2 * (os.cpu_count() or 4))
    finally:
        sys.setswitchinterval(interval)
    for n, (mine, theirs) in enumerate(zip(got, ref)):
        for a, b in zip(mine[:2], theirs[:2]):
            for name in a._fields:
                np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                              err_msg=f"batch {n}: {name}")


def test_worker_times_are_the_loader_spans(roots, monkeypatch):
    """_build's WorkerTimes are the seconds of its four loader.* spans, and
    EvalLoader's length is the number of groups it yields."""
    parts = ("pipeline", "collate", "pack", "stage")
    cfg = default_config(**SMALL)
    ds = make_concat(datasets, pipelines, roots[:1], train=False)
    one = profiling.SpanTotals()
    monkeypatch.setattr(profiling, "SPANS", one)
    times = []
    _build(lambda: [ds[0], ds[1]], cfg, None, DeviceStager("cpu"), times)
    (t,) = times
    assert {f"loader.{p}": (1, getattr(t, p)) for p in parts} == one.snapshot()
    assert t.thread == threading.current_thread().name

    many = profiling.SpanTotals()
    monkeypatch.setattr(profiling, "SPANS", many)
    loader = EvalLoader(ds, cfg, 2, num_threads=2, device="cpu")
    groups = list(loader)
    times = list(loader.times)
    assert len(loader) == len(groups) == len(times) == 2
    snap = many.snapshot()
    for p in parts:
        count, seconds = snap[f"loader.{p}"]
        assert count == len(times)
        assert seconds == pytest.approx(sum(getattr(w, p) for w in times), rel=1e-9)
