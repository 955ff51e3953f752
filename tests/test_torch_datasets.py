"""The port's datasets (``unidet3d_tpu_torch/data/datasets.py``) against the JAX
package's: the same samples for the same RandomState from on-disk datasets in
the reference's info format (train draws, test order, label mappings,
``scene_size``, ``partition``), ``ConcatDataset``; and the port's ``collate``
with ``elastic_coords`` against the JAX collate (``PointBatch``, ``GTBatch``
and the GridPack tables)."""
import os

import numpy as np
import pytest

from tests.test_data_pipeline import make_fake_scene
from tests.test_torch_transforms import assert_samples_equal
from unidet3d_tpu.core.config import default_config as jax_config
from unidet3d_tpu.data import datasets as jax_datasets
from unidet3d_tpu.data import pipelines as jax_pipelines
from unidet3d_tpu.data.batcher import collate as jax_collate
from unidet3d_tpu.data.dataset_specs import DEFAULT_LABEL_MAPPINGS as JAX_MAPPINGS
from unidet3d_tpu_torch.core.config import default_config
from unidet3d_tpu_torch.data import datasets, pipelines
from unidet3d_tpu_torch.data.batcher import collate
from unidet3d_tpu_torch.data.dataset_specs import DEFAULT_LABEL_MAPPINGS

DATASETS = ("scannet", "s3dis", "multiscan", "3rscan", "scannetpp", "arkitscenes")
CAPS = dict(max_points=1536, voxel_capacity=2048, max_superpoints=48, max_gts=8,
            num_planes=(8, 16, 24))


def write_dataset(root, name, n_scenes=3):
    """Scenes of make_fake_scene (2000 points, 6 instances whose labels 0-5
    a MultiScan / 3RScan mapping partly drops), with yawed boxes for
    ARKitScenes; returns the info file's path."""
    import pickle

    entries = [make_fake_scene(root, f"scene{i}", n=2000 + 300 * i, n_inst=6, seed=i,
                               yaw=name == "arkitscenes")
               for i in range(n_scenes)]
    path = os.path.join(root, "infos.pkl")
    with open(path, "wb") as f:
        pickle.dump({"metainfo": {}, "data_list": entries}, f)
    return path


def both_datasets(tmp_path, name, train, partition=1.0):
    root = str(tmp_path / name)
    write_dataset(root, name)
    didx = DATASETS.index(name)
    assert DEFAULT_LABEL_MAPPINGS == JAX_MAPPINGS

    def make(mod, pipes, mappings):
        pipe = pipes.train_pipeline(name) if train else pipes.test_pipeline(name)
        return mod.IndoorDataset(root, "infos.pkl", didx, pipeline=pipe,
                                 test_mode=not train, partition=partition,
                                 label_mapping=mappings[name], seed=didx)

    return (make(datasets, pipelines, DEFAULT_LABEL_MAPPINGS),
            make(jax_datasets, jax_pipelines, JAX_MAPPINGS))


@pytest.mark.parametrize("name", ["scannet", "multiscan", "3rscan", "arkitscenes"])
def test_train_samples_match_jax(tmp_path, name):
    mine, ref = both_datasets(tmp_path, name, train=True, partition=0.5)
    assert len(mine) == len(ref) == 1
    for seed in range(4):
        a = mine.get(0, np.random.RandomState(seed))
        b = ref.get(0, np.random.RandomState(seed))
        assert_samples_equal(a, b)
    if name == "scannet":
        assert "elastic_coords" in a and len(a["gt_labels_3d"])
    if name == "multiscan":  # raw labels 0-2 are not MultiScan classes
        assert set(a["gt_labels_3d"].tolist()) <= {0, 1, 2}


@pytest.mark.parametrize("name", ["scannet", "multiscan", "arkitscenes"])
def test_test_samples_and_sizes_match_jax(tmp_path, name):
    mine, ref = both_datasets(tmp_path, name, train=False)
    assert len(mine) == len(ref) == 3
    for i in range(len(mine)):
        assert mine.scene_size(i) == ref.scene_size(i) == 2000 + 300 * i
        assert_samples_equal(mine[i], ref[i])


def test_concat_dataset_matches_jax(tmp_path):
    pairs = [both_datasets(tmp_path, name, train=True) for name in ("scannet", "arkitscenes")]
    mine = datasets.ConcatDataset([m for m, _ in pairs])
    ref = jax_datasets.ConcatDataset([r for _, r in pairs])
    assert len(mine) == len(ref) == 6
    for idx in range(len(mine)):
        assert_samples_equal(mine.get(idx, np.random.RandomState(idx)),
                             ref.get(idx, np.random.RandomState(idx)))


def test_collate_with_elastic_coords_matches_jax(tmp_path):
    mine_ds, ref_ds = both_datasets(tmp_path, "scannet", train=True)
    samples = [mine_ds.get(0, np.random.RandomState(s)) for s in (0, 1, 2)]
    # The elastic distortion ran (p = 0.5): vox_src is not points / voxel_size.
    assert any(not np.allclose(s["elastic_coords"], s["points"][:, :3] / 0.02, atol=1e-3)
               for s in samples)
    batch, gt, pack = collate(samples, default_config(**CAPS), rng=np.random.RandomState(5))
    jbatch, jgt, jpack = jax_collate(samples, jax_config(subm_impl="xla", **CAPS),
                                     training=True, rng=np.random.RandomState(5))
    for mine, ref in ((batch, jbatch), (gt, jgt)):
        for name, value in ref._asdict().items():
            np.testing.assert_array_equal(getattr(mine, name), value, err_msg=name)
    for i, s in enumerate(samples):  # subsampled rows of elastic_coords
        n = min(len(s["points"]), CAPS["max_points"])
        assert np.isin(batch.vox_src[i, :n, 0], s["elastic_coords"][:, 0]).all()
    for name in ("valid", "neighbors", "parent", "offset_code"):
        for a, b in zip(getattr(pack, name), getattr(jpack, name)):
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)
    np.testing.assert_array_equal(pack.point_inverse, jpack.point_inverse)
