"""The port's experiment files (``unidet3d_tpu_torch/configs/``) against
their JAX twins (the repo's ``configs/``): every ExperimentConfig field, every
DatasetSpec and every field of the port's ModelConfig equal (the JAX
config's mesh axis and TPU-only fields aside)."""
import dataclasses
import os

import pytest

from unidet3d_tpu.core.experiment import load_experiment as jax_load
from unidet3d_tpu_torch.core.experiment import load_experiment

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", ["unidet3d_joint", "unidet3d_scannet"])
def test_port_config_equals_its_jax_twin(name):
    mine = load_experiment(os.path.join(ROOT, "unidet3d_tpu_torch", "configs", f"{name}.py"))
    ref = jax_load(os.path.join(ROOT, "configs", f"{name}.py"))
    fields = [f.name for f in dataclasses.fields(mine)]
    assert fields == [f.name for f in dataclasses.fields(ref)]
    for field in fields:
        if field not in ("model", "datasets"):
            assert getattr(mine, field) == getattr(ref, field), field
    assert [dataclasses.asdict(s) for s in mine.datasets] == [
        dataclasses.asdict(s) for s in ref.datasets]
    assert ref.model.axis_name == "data"
    for f in dataclasses.fields(mine.model):
        assert getattr(mine.model, f.name) == getattr(ref.model, f.name), f.name
    assert (mine.batch_size, mine.epochs) == (8, 1024)
    assert mine.work_dir == f"work_dirs/{name}"


def test_joint_config_mixture():
    mine = load_experiment(os.path.join(ROOT, "unidet3d_tpu_torch", "configs",
                                        "unidet3d_joint.py"))
    parts = [(s.name, s.partition) for s in mine.datasets]
    assert parts == [("scannet", 1.0)] + [("s3dis", 0.33)] * 5 + [
        ("multiscan", 0.25), ("3rscan", 0.15), ("scannetpp", 0.33), ("arkitscenes", 0.08)]
    assert [s.ann_train for s in mine.datasets[1:6]] == [
        f"s3dis_infos_Area_{a}.pkl" for a in (1, 2, 3, 4, 6)]
    assert [s.ann_val for s in mine.datasets[1:6]] == ["s3dis_infos_Area_5.pkl"] + [None] * 4
