"""Scenes on disk from the seed, and the staged training batches built from
them, through either the program's data path or the reference's frozen copy
of it (the same calls: datasets, train pipelines, collate, rulebooks)."""
from __future__ import annotations

import concurrent.futures
import os
import pickle
import types

import numpy as np

from . import scenes

TRAIN_ANN = "infos_train.pkl"
VAL_ANN = "infos_val.pkl"
WARM_ANN = "infos_warm.pkl"


def program_data() -> types.SimpleNamespace:
    from unidet3d_tpu_torch.data import batcher, datasets, pipelines
    from unidet3d_tpu_torch.data.dataset_specs import DEFAULT_LABEL_MAPPINGS

    return types.SimpleNamespace(
        IndoorDataset=datasets.IndoorDataset, ConcatDataset=datasets.ConcatDataset,
        train_pipeline=pipelines.train_pipeline, test_pipeline=pipelines.test_pipeline,
        mappings=DEFAULT_LABEL_MAPPINGS, collate=batcher.collate,
        build_packs=batcher.build_packs, to_device=batcher.to_device,
        gt_to_device=batcher.gt_to_device)


def reference_data() -> types.SimpleNamespace:
    from ..reference.refnet.data import batcher, datasets, pipelines
    from ..reference.refnet.data.dataset_specs import DEFAULT_LABEL_MAPPINGS

    return types.SimpleNamespace(
        IndoorDataset=datasets.IndoorDataset, ConcatDataset=datasets.ConcatDataset,
        train_pipeline=pipelines.train_pipeline, test_pipeline=pipelines.test_pipeline,
        mappings=DEFAULT_LABEL_MAPPINGS, collate=batcher.collate,
        build_packs=batcher.build_packs, to_device=batcher.to_device,
        gt_to_device=batcher.gt_to_device)


def dataset_index(name: str) -> int:
    from ..reference.refnet.core.config import default_config

    return default_config().datasets.index(name)


def sizes_of(lo_hi, count: int, seed: int, ds: int) -> list:
    """`count` point counts spread evenly over [lo, hi], in an order drawn
    from the seed: every seed gets the same sizes."""
    lo, hi = lo_hi
    sizes = np.linspace(lo, hi, count).round().astype(int)
    order = np.random.RandomState(scenes.scene_seed(seed, ds, 10_000)).permutation(count)
    return [int(s) for s in sizes[order]]


def write(root: str, points: dict, counts: dict, seed: int, ann: str, entries: dict = None) -> dict:
    """{dataset name: data root}: for each dataset of `counts`, counts[name]
    scenes with sizes_of(points[name]) (entries[name]: the info file's
    order of them, repeats allowed)."""
    roots = {}
    for name, n in counts.items():
        ds = dataset_index(name)
        roots[name] = scenes.write_dataset(root, ds, sizes_of(points[name], n, seed, ds), seed,
                                           ann, (entries or {}).get(name))
    return roots


def write_warm_info(roots: dict, entries: dict, group: int) -> None:
    """Beside each dataset's VAL_ANN, the warm-up's info file WARM_ANN: each
    distinct scene file `group` times, then as many more of the smallest as
    the pass's last group holds. A pass over it meets every group shape of
    a pass over VAL_ANN (the loader sorts by size, largest first, and pads
    a group to the bucket of its largest scene)."""
    for name, root in roots.items():
        with open(os.path.join(root, VAL_ANN), "rb") as f:
            info = pickle.load(f)
        first = {}
        for entry, file_i in zip(info["data_list"], entries[name]):
            first.setdefault(file_i, entry)
        sizes = {i: os.path.getsize(os.path.join(root, e["lidar_points"]["lidar_path"]))
                 for i, e in first.items()}
        files = sorted(first, key=lambda i: -sizes[i])
        data_list = [first[i] for i in files for _ in range(group)]
        data_list += [first[files[-1]]] * (len(entries[name]) % group)
        with open(os.path.join(root, WARM_ANN), "wb") as f:
            pickle.dump({"metainfo": info["metainfo"], "data_list": data_list}, f)


def train_dataset(pkg, name: str, root: str):
    return pkg.IndoorDataset(root, TRAIN_ANN, dataset_index(name),
                             pipeline=pkg.train_pipeline(name, augment=True),
                             label_mapping=pkg.mappings.get(name))


def staged_batch(pkg, datasets: dict, picks, rng, cfg, half: bool = False):
    """Collated host (PointBatch, GTBatch, GridPack) of the scenes `picks`
    [(dataset name, scene index)], each through its dataset's train
    pipeline with augmentation, drawing from `rng` as a TrainLoader batch
    does (pipelines in order, then collate). `half`: collate only the first
    half of the scenes (the correctness control's planted fault)."""
    samples = []
    for name, i in picks:
        ds = datasets[name]
        sample = ds.load_raw(i)
        for t in ds.pipeline:
            sample = t(sample, rng=rng)
        samples.append(sample)
    if half:
        samples = samples[: len(samples) // 2]
    batch, gt, _ = pkg.collate(samples, cfg, rng=rng, build_rulebooks=False)
    pack = pkg.build_packs(batch.vox_src, batch.valid, cfg)
    return batch, gt, pack


def batch_picks(batch_mix: dict, k: int) -> list:
    """Batch k's scenes: for each dataset of the mix in order, its n scenes
    k * n .. k * n + n - 1."""
    return [(name, k * n + j) for name, n in batch_mix.items() for j in range(n)]


def in_threads(fn, args: list) -> list:
    """[fn(*a) for a in args], on one thread each (numpy and scipy release
    the GIL in their large loops), in order."""
    with concurrent.futures.ThreadPoolExecutor(max_workers=len(args)) as pool:
        return list(pool.map(lambda a: fn(*a), args))


def on_device(pkg, host: tuple, device) -> tuple:
    """(PointBatch, GTBatch, GridPack, host dataset ids) on `device`."""
    batch, gt, pack = host
    dev_b, dev_p = pkg.to_device(batch, pack, device)
    return dev_b, pkg.gt_to_device(gt, device), dev_p, batch.dataset_ids
