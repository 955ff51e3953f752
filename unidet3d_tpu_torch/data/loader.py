"""Training and eval loaders: pipeline, collate, the native rulebook build and
the copy to the card run on host threads while the card computes.

The port of the JAX package's ``data/loader.py`` (single process, one
shard): the same per-batch RandomState, reorder buffer, size-sorted eval
groups and capacity buckets, so that one seed gives the same batches and
groups in both packages.

Device staging is the PyTorch form of the JAX loader's transfer on the loader
thread. A worker copies its collated arrays into pinned host tensors, issues
``non_blocking`` copies on the loader's own CUDA stream and records an event;
it waits for that event itself, so the pinned buffers are released only after
their copies completed. The consumer makes its current stream wait on the
event and calls ``record_stream`` on every tensor, so that the caching
allocator does not hand a batch's memory back to the side stream while the
consumer's work still reads it. With device="cpu" the loaders yield CPU
tensors (views of the collated arrays) and use no stream.
"""
from __future__ import annotations

import collections
import dataclasses
import os
import queue
import threading
import time
from typing import Iterator, NamedTuple

import numpy as np
import torch

from ..core.config import ModelConfig
from ..device import resolve_device
from ..models.detector import GTBatch, PointBatch
from ..ops.gridpack import GridPack
from ..train.profiling import span
from .batcher import build_packs, collate, map_arrays


class Staged(NamedTuple):
    trees: tuple  # (PointBatch, GTBatch, GridPack) of tensors on the device
    event: object  # torch.cuda.Event after the copies, or None on the CPU


class DeviceStager:
    """Moves collated numpy trees to `device` from a worker thread; the
    consumer calls ``ready`` before it uses them."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)

    def stage(self, trees: tuple) -> Staged:
        """On a worker thread: the trees' arrays as device tensors."""
        if self.stream is None:
            return Staged(tuple(map_arrays(torch.from_numpy, t) for t in trees), None)
        pinned = []

        def put(x):
            host = torch.from_numpy(np.ascontiguousarray(x)).pin_memory()
            pinned.append(host)
            return host.to(self.device, non_blocking=True)

        with torch.cuda.stream(self.stream):
            dev = tuple(map_arrays(put, t) for t in trees)
            event = torch.cuda.Event()
            event.record(self.stream)
        # The pinned buffers must outlive their copies: wait for them here,
        # off the consumer's thread (the wait releases the GIL).
        event.synchronize()
        del pinned
        return Staged(dev, event)

    def ready(self, staged: Staged) -> tuple:
        """On the consumer's thread: its current stream waits for the copies,
        and every tensor is marked as used by that stream."""
        if staged.event is None:
            return staged.trees
        current = torch.cuda.current_stream(self.device)
        current.wait_event(staged.event)
        for tree in staged.trees:
            map_arrays(lambda x: x.record_stream(current), tree)
        return staged.trees


@dataclasses.dataclass
class WorkerTimes:
    """Seconds one worker spent on one batch, by part: the seconds of its
    ``loader.*`` spans."""
    thread: str
    pipeline: float  # dataset reads and the transforms
    collate: float  # padding, subsampling, features, ground truth
    pack: float  # the rulebook build
    stage: float  # pinned copies and the H2D copy, waited for


class TrainBatch(NamedTuple):
    batch: PointBatch  # tensors on the loader's device
    gt: GTBatch
    pack: GridPack  # n_valid stays host ints
    host: tuple  # the collated numpy (PointBatch, GTBatch, GridPack)


class _Failed(NamedTuple):
    error: BaseException


def _build(samples_fn, cfg, rng, stager, times, group_cfg=None):
    """Pipeline -> collate -> rulebooks -> staging for one batch, each part a
    span (``loader.*``) whose seconds go into `times`; `group_cfg(samples)`
    picks the batch's config (the eval buckets), else `cfg`. Returns
    (samples, config, the collated numpy (PointBatch, GTBatch, GridPack),
    Staged)."""
    with span("loader.pipeline") as pipeline:
        samples = samples_fn()
        cfg_b = cfg if group_cfg is None else group_cfg(samples)
    with span("loader.collate") as collated:
        batch, gt, _ = collate(samples, cfg_b, rng=rng, build_rulebooks=False)
    with span("loader.pack") as packed:
        pack = build_packs(batch.vox_src, batch.valid, cfg_b)
    host = (batch, gt, pack)
    with span("loader.stage") as staging:
        staged = stager.stage(host)
    times.append(WorkerTimes(threading.current_thread().name, pipeline.seconds,
                             collated.seconds, packed.seconds, staging.seconds))
    return samples, cfg_b, host, staged


class TrainLoader:
    """Infinite loader: each batch draws `batch_size` random scenes from the
    concat dataset (the reference's random scene draw per __getitem__).

    Reproducible whatever the thread count or schedule: batch n is built from
    its own RandomState derived from (seed, n), from which the scene draws,
    the pipeline's augmentations and collate's subsampling all draw, and the
    consumer reassembles batches in index order through a reorder buffer.
    The first batch yielded is batch `start`: the training loop starts at 1,
    since the JAX loop draws batch 0 to initialise its state. Yields
    TrainBatch. A worker's exception is raised in the consumer."""

    def __init__(self, dataset, cfg: ModelConfig, batch_size: int, seed: int = 0,
                 prefetch: int = 2, num_threads: int | None = None, device="cuda",
                 start: int = 0):
        if num_threads is None:
            # Half the cores: the workers' numpy / scipy pipelines hold the
            # GIL in parts, and the native builder spreads its loops over
            # every core, so more workers slow the thread that issues the
            # step's launches (PERF.md: on an 8-core host with one H100, 4
            # workers sustained more scenes/s than 8).
            num_threads = max(2, min((os.cpu_count() or 2) // 2, 8))
        self.dataset = dataset
        self.cfg = cfg
        self.batch_size = batch_size
        self.seed = seed
        self.stager = DeviceStager(device)
        self.times = collections.deque(maxlen=4096)  # WorkerTimes per batch
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._n_drawn = start  # next batch index to build (guarded by _lock)
        self._buf: dict = {}  # consumer-side reorder buffer
        self._next_out = start  # next batch index to yield
        self._threads = [
            threading.Thread(target=self._worker, daemon=True,
                             name=f"train-loader-{i}")
            for i in range(num_threads)
        ]
        for t in self._threads:
            t.start()

    def _batch_rng(self, n: int) -> np.random.RandomState:
        """Per-batch RandomState keyed by (seed, batch index)."""
        return np.random.RandomState(
            np.random.SeedSequence([self.seed, n]).generate_state(4)
        )

    def _samples(self, rng):
        idxs = rng.randint(len(self.dataset), size=self.batch_size)
        return [self.dataset.get(i, rng) for i in idxs]

    def _worker(self):
        while not self._stop.is_set():
            with self._lock:
                n = self._n_drawn
                self._n_drawn += 1
            rng = self._batch_rng(n)
            try:
                _, _, host, staged = _build(lambda: self._samples(rng), self.cfg, rng,
                                            self.stager, self.times)
                item = (n, (host, staged))
            except BaseException as e:  # raised again in the consumer
                item = (n, _Failed(e))
            # Re-offer the same batch to a slow consumer: a built batch is
            # never thrown away. The timeout lets close() stop a blocked worker.
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=5)
                    break
                except queue.Full:
                    continue
            if isinstance(item[1], _Failed):
                return

    def __iter__(self) -> Iterator[TrainBatch]:
        return self

    def __next__(self) -> TrainBatch:
        # Drain the queue into the reorder buffer until the next in-order
        # batch arrives; draining keeps the workers from blocking.
        while self._next_out not in self._buf:
            n, b = self._q.get()
            if isinstance(b, _Failed):
                raise RuntimeError(f"TrainLoader worker failed on batch {n}") from b.error
            self._buf[n] = b
        host, staged = self._buf.pop(self._next_out)
        self._next_out += 1
        return TrainBatch(*self.stager.ready(staged), host)

    def close(self, timeout: float = 60.0):
        """Stops the workers: each finishes the batch it is building."""
        self._stop.set()
        self._buf.clear()
        deadline = time.monotonic() + timeout
        while any(t.is_alive() for t in self._threads) and time.monotonic() < deadline:
            try:
                self._q.get(timeout=0.1)
            except queue.Empty:
                pass
        for t in self._threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))


def capacity_buckets(cfg: ModelConfig) -> tuple:
    """Eval padding buckets: 1/4, 1/2, 5/8, 3/4, 7/8, 15/16 and all of the
    configured point capacity, each at least 4096 and rounded up to a
    multiple of 512 (the JAX package's rounding, kept so that both packages
    pick the same bucket for a group). Every op of the forward scales with
    the padded capacity, so a group pays for the smallest bucket that holds
    it."""
    def a512(v):
        return -(-v // 512) * 512

    full = cfg.max_points
    return tuple(
        sorted(
            {
                min(a512(max(num * full // den, 4096)), full)
                for num, den in
                ((1, 4), (1, 2), (5, 8), (3, 4), (7, 8), (15, 16), (1, 1))
            }
        )
    )


def superpoint_buckets(cfg: ModelConfig) -> tuple:
    """Eval superpoint (query) padding rungs: multiples of 1024 up to the
    configured cap, and the cap itself. Every superpoint is a query in eval,
    so the decoder's cost scales with the padded superpoint capacity."""
    full = cfg.max_superpoints
    rungs = {min(r, full) for r in range(1024, full + 1024, 1024)}
    rungs.add(full)
    return tuple(sorted(rungs))


class EvalLoader:
    """Batched eval prefetcher: one dataset's scenes in groups of
    `batch_size`, collated, rulebook-built and staged on worker threads.

    Scenes are grouped in descending size order (``scene_size``) so that
    small scenes do not pad up to a large one's bucket; each group is padded
    to the smallest capacity bucket whose per-level voxel capacities hold it
    and the smallest superpoint rung that holds its superpoints. The final
    group repeats its last scene; `n_real` counts the genuine ones. With
    shard_count > 1 this process takes every shard_count-th scene of the
    sorted order from shard_idx. Yields (samples, PointBatch, GTBatch,
    GridPack, n_real, cfg) with the arrays on the loader's device and `cfg`
    the group's bucket config. A worker's exception is raised in the
    consumer. Test pipelines that subsample draw from the dataset's own
    RandomState, as in the JAX package: with several threads their draws
    follow the schedule."""

    def __init__(self, dataset, cfg: ModelConfig, batch_size: int, prefetch: int = 2,
                 buckets: tuple | None = None, sort_by_size: bool = True,
                 shard_idx: int = 0, shard_count: int = 1,
                 num_threads: int | None = None, device="cuda"):
        if not 0 <= shard_idx < shard_count:
            raise ValueError(f"shard {shard_idx} of {shard_count}")
        if num_threads is None:
            num_threads = max(1, min(os.cpu_count() or 1, 6))
        self.dataset = dataset
        self.cfg = cfg
        self.batch_size = batch_size
        self.stager = DeviceStager(device)
        self.times = collections.deque(maxlen=4096)  # WorkerTimes per group
        self.buckets = capacity_buckets(cfg) if buckets is None else buckets
        self._order = self._scene_order(sort_by_size)[shard_idx::shard_count]
        self._q: queue.Queue = queue.Queue(maxsize=max(prefetch, num_threads))
        self._n_groups = -(-len(self._order) // batch_size)
        self._next_g = 0  # next group index to build (guarded by _lock)
        self._lock = threading.Lock()
        self._err: BaseException | None = None
        self._threads = [
            threading.Thread(target=self._worker, daemon=True, name=f"eval-loader-{i}")
            for i in range(num_threads)
        ]
        for t in self._threads:
            t.start()

    def __len__(self) -> int:
        """The number of groups this loader yields (this shard's)."""
        return self._n_groups

    def group_indices(self, g: int) -> list:
        """The dataset indices (info-file order) of group g's real scenes, in
        the group's order; the padded slots that repeat the last scene are
        not listed."""
        lo = g * self.batch_size
        return [int(i) for i in self._order[lo:lo + self.batch_size]]

    def _scene_order(self, sort_by_size: bool) -> np.ndarray:
        n = len(self.dataset)
        if sort_by_size and hasattr(self.dataset, "scene_size"):
            try:
                sizes = np.asarray([self.dataset.scene_size(i) for i in range(n)])
                return np.argsort(-sizes, kind="stable")
            except OSError:  # missing files: fall back to dataset order
                pass
        return np.arange(n)

    def _scene_level_needs(self, sample) -> np.ndarray:
        """Per-U-Net-level voxel counts of one scene (an upper bound: collate
        may still subsample points above the bucket cap)."""
        pts = sample["points"]
        c = sample.get("elastic_coords")
        if c is None:
            c = pts[:, :3] / self.cfg.voxel_size
        ic = np.floor(c - c.min(0)).astype(np.int64)
        ic = np.clip(ic, 0, 4095)
        needs = []
        for _ in range(len(self.cfg.num_planes)):
            key = (ic[:, 0] << 24) | (ic[:, 1] << 12) | ic[:, 2]
            needs.append(len(np.unique(key)))
            ic >>= 1
        return np.asarray(needs)

    def _bucket_cfg(self, samples) -> ModelConfig:
        """The smallest bucket whose per-level capacities hold the group's
        quantized voxel counts (coarse levels compress less than 2x on
        sparse scans, so a point count alone could drop voxels), and the
        smallest superpoint rung that holds every scene's superpoints."""
        cfg_b = self.cfg
        need_pts = max(len(s["points"]) for s in samples)
        need_vox = np.max(np.stack([self._scene_level_needs(s) for s in samples]), axis=0)
        for cap in self.buckets:
            if cap >= self.cfg.max_points:
                break
            cfg_c = dataclasses.replace(
                self.cfg, max_points=cap,
                voxel_capacity=min(cap, self.cfg.voxel_capacity),
            )
            if need_pts <= cap and all(
                n <= c for n, c in zip(need_vox, cfg_c.level_capacities(1))
            ):
                cfg_b = cfg_c
                break

        need_sp = 0
        for s in samples:
            sp = s.get("sp_pts_mask")
            if sp is None or len(sp) == 0:
                continue
            need_sp = max(need_sp, int(np.max(sp)) + 1)
        for rung in superpoint_buckets(self.cfg):
            if need_sp <= rung:
                if rung < cfg_b.max_superpoints:
                    cfg_b = dataclasses.replace(cfg_b, max_superpoints=rung)
                break
        return cfg_b

    def _worker(self):
        n = len(self._order)
        try:
            while True:
                with self._lock:
                    g = self._next_g
                    self._next_g += 1
                if g >= self._n_groups:
                    break
                lo = g * self.batch_size
                idxs = [int(self._order[min(lo + j, n - 1)])
                        for j in range(self.batch_size)]
                samples, cfg_b, _, staged = _build(
                    lambda: [self.dataset[i] for i in idxs], self.cfg, None,
                    self.stager, self.times, self._bucket_cfg)
                n_real = len(self.group_indices(g))
                self._q.put((g, (samples, staged, n_real, cfg_b)))
        except BaseException as e:  # surface in the consumer, don't hang it
            self._err = e
        finally:
            self._q.put(None)

    def __iter__(self):
        # Reassemble groups in index order; done when every worker signalled.
        buf: dict = {}
        next_out = 0
        done = 0
        while next_out < self._n_groups:
            while next_out not in buf:
                item = self._q.get()
                if item is None:
                    done += 1
                    if self._err is not None:
                        raise RuntimeError("EvalLoader worker failed") from self._err
                    if done == len(self._threads) and next_out not in buf:
                        return
                    continue
                g, payload = item
                buf[g] = payload
            samples, staged, n_real, cfg_b = buf.pop(next_out)
            batch, gt, pack = self.stager.ready(staged)
            yield samples, batch, gt, pack, n_real, cfg_b
            next_out += 1
