"""Training LEARNS in the port, not just runs: the counterpart of
``tests/test_overfit.py``.

The same experiment as the JAX package's check: a small model overfits 4
coherent synthetic ScanNet scenes (``tests/test_data_pipeline.py::
write_coherent_dataset``: compact instances whose superpoints each lie in
one instance), 100 one-step epochs of batch 8 at lr 3e-3 with no
augmentation and seed 3, through the port's ``train(exp, device="cpu")``
and then ``evaluate``. It holds the JAX test's three bars: the mean of the
last 3 losses under 1/5 of the first 3, mAP@0.25 > 0.9 and mAR@0.25 == 1.0.
A one-step parity test cannot see what this exercises over 100 steps: the
PolyLR schedule, AdamW's moments over time, the running BN statistics
handed from training to eval, the matcher once the queries specialise, and
the hand-off from ``train()`` to ``evaluate()``.

The port's own copy of the data writer (``data/synthetic.py::
write_coherent_dataset``, which ``chip_smoke.py``'s ``[overfit-small]``
trains on) writes the JAX helper's files byte for byte. PyTorch runs on 2
intra-op threads here: the test shares the host with the other test
workers, and 2 threads keep it near its time alone.

``test_torch_overfit_matches_jax`` (slow: the JAX run compiles its step for
the 8-device CPU mesh) trains both packages on the same data, config and
seed; each must clear the bars, and their mAP@0.25 lie within 0.1.
"""
import logging
import os

import numpy as np
import pytest
import torch

from tests.test_data_pipeline import write_coherent_dataset
from unidet3d_tpu_torch.core.config import default_config
from unidet3d_tpu_torch.core.experiment import DatasetSpec, ExperimentConfig
from unidet3d_tpu_torch.data import synthetic
from unidet3d_tpu_torch.train.loop import evaluate, train

# tests/test_overfit.py's config: tests/test_detector.py::small_config with
# these overrides, on the port's default_config (bf16 compute, as there).
SMALL = dict(max_points=1024, voxel_capacity=1024, max_superpoints=48, max_gts=8,
             query_thr=48, num_planes=(8, 16), d_model=32, num_heads=4, hidden_dim=64,
             num_layers=2, topk_insts=32)
EPOCHS = 100
LR = 3e-3
SEED = 3
MAP_BAR = 0.9  # mAP@0.25 above it; mAR@0.25 exactly 1.0
LOSS_FALL = 5  # mean of the last 3 losses under the first 3's over LOSS_FALL
MAP_AGREE = 0.1  # |port - JAX| mAP@0.25 in the slow parity test


def experiment(root, work_dir, model, datasets_spec=DatasetSpec, exp_cls=ExperimentConfig):
    """tests/test_overfit.py's experiment over `root`: batch 8 of 4 scenes
    (one step an epoch), validation out of reach, one checkpoint at the
    end."""
    return exp_cls(
        model=model,
        datasets=(datasets_spec(name="scannet", data_root=root, ann_train="infos.pkl",
                                ann_val="infos.pkl", augment=False),),
        batch_size=8, epochs=EPOCHS, steps_per_epoch=0, lr=LR, work_dir=str(work_dir),
        val_interval_epochs=100000, val_last_epochs=0, ckpt_interval_epochs=EPOCHS,
        seed=SEED)


class Losses(logging.Handler):
    """The loss of each interval line (`train_stats` kind "interval")."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.losses = []

    def emit(self, record):
        stats = getattr(record, "train_stats", None)
        if stats and stats["kind"] == "interval":
            self.losses.append(stats["loss"])


def train_port(root, work_dir):
    """(losses per step, evaluate's results) of the port on the CPU."""
    exp = experiment(root, work_dir, default_config(**SMALL))
    logger = logging.getLogger("unidet3d_tpu_torch")
    handler, level = Losses(), logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        model, _ = train(exp, device="cpu")
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
    return handler.losses, evaluate(exp, model, device="cpu", logger=lambda *a, **k: None)


def assert_learned(losses, results, epochs=EPOCHS):
    """The JAX test's three bars."""
    assert len(losses) >= epochs, len(losses)
    early, late = float(np.mean(losses[:3])), float(np.mean(losses[-3:]))
    assert late < early / LOSS_FALL, (early, late)
    res = results["scannet"]
    assert res["mAP_0.25"] > MAP_BAR, res
    assert res["mAR_0.25"] == 1.0, res
    return early, late


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def coherent_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("overfit") / "scannet")
    write_coherent_dataset(root, n_scenes=4)
    return root


def test_port_writer_equals_the_jax_helper(coherent_root, tmp_path):
    mine = str(tmp_path / "scannet")
    synthetic.write_coherent_dataset(mine, n_scenes=4)

    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    assert files(mine) == files(coherent_root) and len(files(mine)) == 17
    for name in files(mine):
        with open(os.path.join(mine, name), "rb") as a, \
                open(os.path.join(coherent_root, name), "rb") as b:
            assert a.read() == b.read(), name


def test_torch_overfit_tiny_dataset(coherent_root, tmp_path):
    losses, results = train_port(coherent_root, tmp_path / "work")
    assert len(losses) == EPOCHS  # one step an epoch: ceil(4 scenes / batch 8)
    assert np.isfinite(losses).all()
    assert_learned(losses, results)


@pytest.mark.slow
def test_torch_overfit_matches_jax(coherent_root, tmp_path, caplog):
    import re

    from tests.test_detector import small_config
    from unidet3d_tpu.core import experiment as jax_experiment
    from unidet3d_tpu.train import loop as jax_loop

    losses, results = train_port(coherent_root, tmp_path / "port")
    assert_learned(losses, results)

    caplog.set_level(logging.INFO, logger="unidet3d_tpu")
    jax_exp = experiment(coherent_root, tmp_path / "jax",
                         small_config(axis_name="data", **SMALL),
                         jax_experiment.DatasetSpec, jax_experiment.ExperimentConfig)
    state = jax_loop.train(jax_exp)
    jax_losses = [float(m.group(1)) for m in re.finditer(
        r"iter \d+/\d+ loss (\d+\.\d+)", "\n".join(r.getMessage() for r in caplog.records))]
    jax_results = jax_loop.evaluate(jax_exp, state)
    assert_learned(jax_losses, jax_results)
    mine, ref = results["scannet"]["mAP_0.25"], jax_results["scannet"]["mAP_0.25"]
    assert abs(mine - ref) <= MAP_AGREE, (mine, ref)
