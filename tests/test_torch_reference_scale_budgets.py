"""The port's default capacities hold reference-scale scenes with ZERO drops:
the counterpart of ``tests/test_reference_scale_budgets.py``.

The reference's ScanNet pipelines keep every point, and S3DIS caps its
scenes at 180,000 points. So the port's ``default_config()`` keeps
``max_points=196608`` and ``voxel_capacity=163840`` per scene. The JAX
test's validation-size mix (ScanNet scans of 52k-190k points and an
S3DIS-cap 180k scene; ``data/synthetic.py::reference_scale_scenes``, which
``chip_smoke.py``'s ``[prod-ref]`` runs on the card) goes through the
port's ``collate`` with the native rulebook builder, and not one point,
superpoint or voxel may be dropped.
"""
import numpy as np

from unidet3d_tpu.data.synthetic import synthetic_scene as jax_synthetic_scene
from unidet3d_tpu_torch.core.config import default_config
from unidet3d_tpu_torch.data.batcher import collate
from unidet3d_tpu_torch.data.synthetic import (
    REFERENCE_SCALE_POINTS as SIZES,
    reference_scale_scenes,
)
from unidet3d_tpu_torch.data.telemetry import DROPS


def test_mix_is_the_jax_tests():
    """The JAX test's scenes: the JAX synthetic_scene(n, seed=100 + i),
    superpoints from the x-rank // 64, dataset 0 (ScanNet)."""
    assert SIZES == (52_000, 96_000, 147_000, 180_000, 190_000)
    for i, (n, sample) in enumerate(zip(SIZES, reference_scale_scenes())):
        pts = jax_synthetic_scene(n, seed=100 + i)
        np.testing.assert_array_equal(sample["points"], pts)
        np.testing.assert_array_equal(
            sample["sp_pts_mask"], np.argsort(np.argsort(pts[:, 0], kind="stable")) // 64)
        assert sample["dataset_idx"] == 0 and sample["sp_pts_mask"].dtype == np.int64


def test_default_config_holds_reference_scale_scenes():
    cfg = default_config()
    assert cfg.max_points >= 196608, "the default must hold uncapped ScanNet scans"
    assert cfg.max_points >= 180000, "the default must hold the S3DIS cap"

    DROPS.reset()
    batch, _, pack = collate(reference_scale_scenes(), cfg)
    drops = DROPS.snapshot(reset=True)
    assert not drops, f"caps {cfg.max_points} / {cfg.voxel_capacity}: {DROPS.format(drops)}"
    assert [int(v.sum()) for v in batch.valid] == list(SIZES)
    assert int(batch.valid.sum()) == 665_000
    caps = cfg.level_capacities(len(SIZES))
    assert all(0 < n <= cap for n, cap in zip(pack.n_valid, caps)), (pack.n_valid, caps)
