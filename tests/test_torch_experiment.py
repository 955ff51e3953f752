"""The port's experiment config (``unidet3d_tpu_torch/core/experiment.py``)
against the JAX package's: ``apply_overrides``, ``resolve_steps_per_epoch``,
``total_steps`` and ``load_experiment`` behave the same."""
import dataclasses

import pytest

from unidet3d_tpu.core import experiment as jax_experiment
from unidet3d_tpu.core.config import default_config as jax_config
from unidet3d_tpu_torch.core import experiment
from unidet3d_tpu_torch.core.config import default_config

SPEC = dict(name="scannet", data_root="data/scannet", ann_train="train.pkl",
            ann_val="val.pkl")


def both():
    return (experiment.ExperimentConfig(model=default_config(),
                                        datasets=(experiment.DatasetSpec(**SPEC),)),
            jax_experiment.ExperimentConfig(model=jax_config(),
                                            datasets=(jax_experiment.DatasetSpec(**SPEC),)))


def test_defaults_match_jax():
    mine, ref = both()
    fields = {f.name for f in dataclasses.fields(ref)} - {"model", "datasets"}
    assert fields == {f.name for f in dataclasses.fields(mine)} - {"model", "datasets"}
    for name in fields:
        assert getattr(mine, name) == getattr(ref, name), name
    assert dataclasses.asdict(mine.datasets[0]) == dataclasses.asdict(ref.datasets[0])


@pytest.mark.parametrize("options", [
    ["lr=1e-3", "epochs=12"],
    ["model.max_points=65536", "model.num_planes=(16, 32)", "work_dir=runs/a=b"],
    ["seed=5", "load_from=None", "model.compute_dtype=float32"],
    ["batch_size=4", "eval_batch_size=2", "model.iou_thr=(0.5, 0.5, 0.5, 0.5, 0.5, 0.5)"],
])
def test_apply_overrides_matches_jax(options):
    mine, ref = both()
    mine = experiment.apply_overrides(mine, options)
    ref = jax_experiment.apply_overrides(ref, options)
    for opt in options:
        key = opt.partition("=")[0]
        a, b = mine, ref
        for part in key.split("."):
            a, b = getattr(a, part), getattr(b, part)
        assert a == b and type(a) is type(b), (key, a, b)
    with pytest.raises(TypeError):
        experiment.apply_overrides(mine, ["no_such_field=1"])


@pytest.mark.parametrize("steps, batch, n", [(0, 8, 100), (0, 8, 96), (0, 4, 1), (0, 8, 0),
                                             (50, 8, 100)])
def test_resolve_steps_per_epoch_matches_jax(steps, batch, n):
    mine, ref = both()
    mine = dataclasses.replace(mine, steps_per_epoch=steps, batch_size=batch, epochs=3)
    ref = dataclasses.replace(ref, steps_per_epoch=steps, batch_size=batch, epochs=3)
    if steps == 0:
        with pytest.raises(AssertionError):
            mine.total_steps
    mine = experiment.resolve_steps_per_epoch(mine, n)
    ref = jax_experiment.resolve_steps_per_epoch(ref, n)
    assert mine.steps_per_epoch == ref.steps_per_epoch
    assert mine.total_steps == ref.total_steps


def test_load_experiment_matches_jax(tmp_path):
    for pkg in ("unidet3d_tpu", "unidet3d_tpu_torch"):
        (tmp_path / f"{pkg}_cfg.py").write_text(
            f"from {pkg}.core.config import default_config\n"
            f"from {pkg}.core.experiment import DatasetSpec, ExperimentConfig\n\n\n"
            "def get_config():\n"
            "    return ExperimentConfig(\n"
            "        model=default_config(max_points=4096, num_layers=2),\n"
            "        datasets=(DatasetSpec('s3dis', 'data/s3dis', ann_val='v.pkl',\n"
            "                              partition=0.5),),\n"
            "        epochs=7, lr=1e-4, work_dir='work/x')\n")
    mine = experiment.load_experiment(str(tmp_path / "unidet3d_tpu_torch_cfg.py"))
    ref = jax_experiment.load_experiment(str(tmp_path / "unidet3d_tpu_cfg.py"))
    assert isinstance(mine, experiment.ExperimentConfig)
    assert isinstance(mine.model, type(default_config()))
    for name in ("epochs", "lr", "work_dir", "batch_size"):
        assert getattr(mine, name) == getattr(ref, name)
    assert (mine.model.max_points, mine.model.num_layers) == (4096, 2)
    assert dataclasses.asdict(mine.datasets[0]) == dataclasses.asdict(ref.datasets[0])
