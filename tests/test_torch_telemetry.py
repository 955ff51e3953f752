"""The port's capacity-drop counters against the JAX package's, on the CPU:
the same samples through both collates, overflowing every cap (points,
superpoints, GTs, instances, level-0 voxels and coarser levels), give the
same six counts.
"""
import numpy as np
import pytest

CAPS = dict(num_planes=(8, 16, 24), max_points=4500, voxel_capacity=4096,
            max_superpoints=16, max_gts=4)
N = 5000


def _sample(seed):
    """5,000 points on distinct voxels of a sparse grid (each one its own
    voxel at levels 0-2), 6 GT boxes, superpoint ids up to 39 and instance
    ids up to 9."""
    rng = np.random.RandomState(seed)
    cells = rng.choice(400 ** 3, N, replace=False)
    coords = np.stack(np.unravel_index(cells, (400, 400, 400)), 1)
    pts = np.zeros((N, 6), np.float32)
    pts[:, :3] = (coords + 0.5) * 0.02  # voxel centres: no rounding at the floor
    pts[:, 3:] = rng.rand(N, 3)
    return {
        "points": pts, "dataset_idx": 0,
        "sp_pts_mask": np.arange(N) % 40,
        "pts_instance_mask": (np.arange(N) % 10).astype(np.int64),
        "gt_bboxes_3d": np.tile(np.float32([[0, 0, 0, 1, 1, 1]]), (6, 1)),
        "gt_labels_3d": np.zeros(6, np.int64),
    }


@pytest.fixture()
def counters():
    from unidet3d_tpu.data.telemetry import DROPS as JAX_DROPS

    from unidet3d_tpu_torch.data.telemetry import DROPS

    JAX_DROPS.reset()
    DROPS.reset()
    yield JAX_DROPS, DROPS
    JAX_DROPS.reset()
    DROPS.reset()


def test_collate_drop_counters_match_jax(counters):
    from unidet3d_tpu.core.config import default_config as jax_config
    from unidet3d_tpu.data.batcher import collate as jax_collate

    from unidet3d_tpu_torch.core.config import default_config
    from unidet3d_tpu_torch.data.batcher import collate

    jax_drops, drops = counters
    samples = [_sample(0), _sample(1)]
    jax_collate(samples, jax_config(subm_impl="xla", **CAPS), rng=np.random.RandomState(0))
    collate(samples, default_config(**CAPS), rng=np.random.RandomState(0))
    ref, mine = jax_drops.snapshot(), drops.snapshot()
    assert mine == ref
    assert set(mine) == {"points_dropped", "superpoints_folded", "gts_dropped",
                         "instances_dropped", "voxels_dropped", "coarse_voxels_dropped"}
    assert mine["points_dropped"] == 2 * (N - CAPS["max_points"])
    assert mine["gts_dropped"] == 2 * 2
    assert drops.format().startswith("coarse_voxels_dropped=")
    assert drops.snapshot(reset=True) == mine and drops.snapshot() == {}


def test_collate_within_caps_counts_nothing(counters):
    from unidet3d_tpu_torch.core.config import default_config
    from unidet3d_tpu_torch.data.batcher import collate

    _, drops = counters
    sample = _sample(2)
    sample["points"] = sample["points"][:900]
    sample.update(sp_pts_mask=np.arange(900) % 16, pts_instance_mask=np.arange(900) % 4,
                  gt_bboxes_3d=sample["gt_bboxes_3d"][:4], gt_labels_3d=np.zeros(4, np.int64))
    collate([sample], default_config(**CAPS))
    assert drops.snapshot() == {}
