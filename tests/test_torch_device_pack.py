"""The port's device-side rulebook builder (``ops/keys.py``,
``ops/voxelize.py``, ``ops/sparse_conv.py::build_subm_neighbors`` /
``build_downsample_map``, ``ops/pyramid.py``,
``ops/gridpack.py::build_gridpack_device``) against the JAX package's, as
``tests/test_voxelize.py`` and ``tests/test_gridpack.py`` hold the JAX
builder: every array equal on random scenes, with and without capacity
overflow; the tables equal the port's host builders' (numpy and native) on
every row; and the detector's forward without a pack (``UniDet3D.forward(
batch, None)``) equal to its forward on the host pack, and to the JAX
detector's ``rulebooks=None`` forward at a small config. Everything runs on
the CPU, where the builder runs the same tensor ops as on the card.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unidet3d_tpu.ops import gridpack as jgridpack
from unidet3d_tpu.ops import keys as jkeys
from unidet3d_tpu.ops import pyramid as jpyramid
from unidet3d_tpu.ops import sparse_conv as jsparse
from unidet3d_tpu.ops import voxelize as jvoxelize
from unidet3d_tpu_torch.ops import keys, pyramid, sparse_conv
from unidet3d_tpu_torch.ops.gridpack import (
    build_gridpack_device,
    build_gridpack_host,
    build_gridpack_numpy,
)
from unidet3d_tpu_torch.ops.voxelize import gather_voxel_to_points, voxelize


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _scene(seed, n=600, batches=3, extent=14, invalid=0.1):
    """(N, 4) int32 (batch, x, y, z) with duplicates, a few coords past the
    clip range and invalid rows."""
    rng = np.random.RandomState(seed)
    bxyz = np.concatenate([rng.randint(0, batches, (n, 1)),
                           rng.randint(0, extent, (n, 3))], 1).astype(np.int32)
    bxyz[:5, 1] = 4095  # on the clip bound: neighbors past it are out of range
    bxyz[5:8, 2] = 5000  # clipped to 4095
    return bxyz, rng.rand(n) > invalid


SCENES = {
    # (seed, capacities): no overflow; level 0 overflowing; coarse overflowing
    "fits": (0, [512, 256, 128]),
    "level 0 overflows": (1, [64, 32]),
    "coarse level overflows": (2, [512, 40, 20]),
}


def _jax_key(k1, k2, valid):
    """The JAX pair as the port's int64 key; invalid rows as INVALID_KEY."""
    k = (np.asarray(k1).astype(np.int64) << 24) | np.asarray(k2).astype(np.int64)
    return np.where(valid, k, keys.INVALID_KEY)


def _grids_equal(mine, ref):
    valid = np.asarray(ref.valid)
    np.testing.assert_array_equal(mine.valid.numpy(), valid)
    assert int(mine.n_voxels) == int(ref.n_voxels)
    np.testing.assert_array_equal(mine.coords.numpy()[valid], np.asarray(ref.coords)[valid])
    np.testing.assert_array_equal(mine.coords.numpy()[~valid], 0)
    np.testing.assert_array_equal(mine.key.numpy(), _jax_key(ref.key1, ref.key2, valid))
    np.testing.assert_array_equal(mine.inverse.numpy(), np.asarray(ref.inverse))
    np.testing.assert_array_equal(mine.counts.numpy(), np.asarray(ref.counts))


def test_pack_keys_and_lookup_match_jax():
    bxyz, valid = _scene(3)
    bxyz[:, 1:] = np.clip(bxyz[:, 1:], 0, keys.MAX_COORD)
    k1, k2 = jkeys.pack_keys(jnp.asarray(bxyz), jnp.asarray(valid))
    mine = keys.pack_keys(_t(bxyz), _t(valid))
    np.testing.assert_array_equal(mine.numpy(), _jax_key(k1, k2, valid))
    # Lookup in a sorted table of half the rows, for every row.
    order = np.lexsort((np.asarray(k2), np.asarray(k1)))[: len(bxyz) // 2]
    order = np.sort(order)
    table = np.sort(mine.numpy()[order])
    j1, j2 = (np.asarray(k)[order] for k in (k1, k2))
    jorder = np.lexsort((j2, j1))
    idx_ref, found_ref = jkeys.lookup_pair(jnp.asarray(j1[jorder]), jnp.asarray(j2[jorder]), k1, k2)
    idx, found = keys.lookup_pair(_t(table), mine)
    np.testing.assert_array_equal(found.numpy(), np.asarray(found_ref))
    np.testing.assert_array_equal(idx.numpy()[found.numpy()], np.asarray(idx_ref)[found.numpy()])
    assert found.any() and not found.all()


@pytest.mark.parametrize("scene", list(SCENES))
def test_voxelize_matches_jax(scene):
    seed, caps = SCENES[scene]
    bxyz, valid = _scene(seed)
    feats = np.random.RandomState(seed).randn(len(bxyz), 3).astype(np.float32)
    ref, ref_f = jax.jit(jvoxelize.voxelize, static_argnums=2)(
        jnp.asarray(bxyz), jnp.asarray(valid), caps[0], jnp.asarray(feats))
    mine, mine_f = voxelize(_t(bxyz), _t(valid), caps[0], _t(feats))
    _grids_equal(mine, ref)
    # Per-voxel means of the same rows: summation order only.
    np.testing.assert_allclose(mine_f.numpy(), np.asarray(ref_f), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(gather_voxel_to_points(mine_f, mine.inverse).numpy(),
                               np.asarray(jvoxelize.gather_voxel_to_points(ref_f, ref.inverse)),
                               rtol=1e-6, atol=1e-6)
    assert (mine.inverse.numpy() == caps[0]).any()  # invalid points: the sentinel


def test_voxelize_dedup_first_point_and_overflow():
    """tests/test_voxelize.py's cases on the port: dedup with feature means,
    the inverse map, an invalid point, and overflow dropping groups."""
    bxyz = np.array([[0, 1, 1, 1], [0, 1, 1, 1], [0, 2, 0, 0], [1, 1, 1, 1], [1, 0, 0, 0],
                     [0, 2, 0, 0]], np.int32)
    feats = np.arange(12, dtype=np.float32).reshape(6, 2)
    grid, vf = voxelize(_t(bxyz), torch.ones(6, dtype=torch.bool), 8, _t(feats))
    assert int(grid.n_voxels) == 4
    np.testing.assert_array_equal(grid.coords[:4].numpy(),
                                  [[0, 1, 1, 1], [0, 2, 0, 0], [1, 0, 0, 0], [1, 1, 1, 1]])
    np.testing.assert_allclose(vf[:4].numpy(), [(feats[0] + feats[1]) / 2,
                                                (feats[2] + feats[5]) / 2, feats[4], feats[3]])
    np.testing.assert_array_equal(grid.counts[:4].numpy(), [2, 2, 1, 1])
    inv = grid.inverse.numpy()
    assert inv[0] == inv[1] and inv[2] == inv[5] and len({inv[0], inv[2], inv[3], inv[4]}) == 4

    valid = np.ones(6, bool)
    valid[3] = False
    grid, _ = voxelize(_t(bxyz), _t(valid), 8)
    assert int(grid.n_voxels) == 3 and int(grid.inverse[3]) == 8
    assert int(grid.key[5]) == keys.INVALID_KEY

    line = np.stack([np.zeros(10), np.arange(10), np.zeros(10), np.zeros(10)], 1).astype(np.int32)
    grid, _ = voxelize(_t(line), torch.ones(10, dtype=torch.bool), 4)
    assert int(grid.n_voxels) == 4 and (grid.inverse.numpy() >= 4).sum() == 6


@pytest.mark.parametrize("scene", list(SCENES))
def test_rulebooks_and_pyramid_match_jax(scene):
    seed, caps = SCENES[scene]
    bxyz, valid = _scene(seed)
    ref0, _ = jax.jit(jvoxelize.voxelize, static_argnums=2)(
        jnp.asarray(bxyz), jnp.asarray(valid), caps[0])
    mine0, _ = voxelize(_t(bxyz), _t(valid), caps[0])
    np.testing.assert_array_equal(sparse_conv.build_subm_neighbors(mine0).numpy(),
                                  np.asarray(jax.jit(jsparse.build_subm_neighbors)(ref0)))
    ref_ds = jax.jit(jsparse.build_downsample_map, static_argnums=1)(ref0, caps[1])
    mine_ds = sparse_conv.build_downsample_map(mine0, caps[1])
    _grids_equal(mine_ds.grid, ref_ds.grid)
    np.testing.assert_array_equal(mine_ds.parent.numpy(), np.asarray(ref_ds.parent))
    np.testing.assert_array_equal(mine_ds.offset_code.numpy(), np.asarray(ref_ds.offset_code))
    ref_p = jax.jit(jpyramid.build_pyramid, static_argnums=1)(ref0, tuple(caps))
    mine_p = pyramid.build_pyramid(mine0, caps)
    for m, r in zip(mine_p.grids, ref_p.grids):
        _grids_equal(m, r)
    for m, r in zip(mine_p.neighbors, ref_p.neighbors):
        np.testing.assert_array_equal(m.numpy(), np.asarray(r))
        assert m.dtype == torch.int32


@pytest.mark.parametrize("scene", list(SCENES))
def test_gridpack_device_matches_jax_and_the_host_builders(scene):
    seed, caps = SCENES[scene]
    bxyz, valid = _scene(seed)
    mine, grid0 = build_gridpack_device(_t(bxyz), _t(valid), caps)
    ref, ref0 = jax.jit(jgridpack.build_gridpack_device, static_argnums=2)(
        jnp.asarray(bxyz), jnp.asarray(valid), tuple(caps))
    for name in ("valid", "neighbors", "parent", "offset_code"):
        for m, r in zip(getattr(mine, name), getattr(ref, name)):
            np.testing.assert_array_equal(m.numpy(), np.asarray(r), err_msg=name)
    np.testing.assert_array_equal(mine.point_inverse.numpy(), np.asarray(ref.point_inverse))
    np.testing.assert_array_equal(grid0.counts.numpy(), np.asarray(ref0.counts))
    assert mine.n_valid == tuple(int(np.asarray(v).sum()) for v in ref.valid)
    assert all(isinstance(n, int) for n in mine.n_valid)
    for builder in (build_gridpack_numpy, build_gridpack_host):
        host, counts0 = builder(bxyz, valid, caps)
        assert mine.n_valid == tuple(host.n_valid)
        for name in ("valid", "neighbors", "parent", "offset_code"):
            for m, h in zip(getattr(mine, name), getattr(host, name)):
                assert m.numpy().dtype == h.dtype, name
                np.testing.assert_array_equal(m.numpy(), h, err_msg=name)
        np.testing.assert_array_equal(mine.point_inverse.numpy(), host.point_inverse)
        np.testing.assert_array_equal(grid0.counts.numpy(), counts0)


def test_quantize_points_device_equals_the_host_quantizer():
    from unidet3d_tpu_torch.ops.gridpack import quantize_points, quantize_points_device

    rng = np.random.RandomState(2)
    vox_src = (rng.rand(3, 100, 3) * 50 - 10).astype(np.float32)
    valid = rng.rand(3, 100) > 0.2
    valid[2] = False  # an empty scene: no shift
    mine = quantize_points_device(_t(vox_src), _t(valid))
    assert mine.dtype == torch.int32
    np.testing.assert_array_equal(mine.numpy(), quantize_points(vox_src, valid))


# ------------------------------------------------------------ the forward

CAPS = dict(max_points=2048, voxel_capacity=2048, max_superpoints=128, max_gts=16,
            query_thr=48, compute_dtype="float32", num_planes=(8, 16, 24),
            num_layers=2, d_model=64, num_heads=2, hidden_dim=64)


def _samples():
    from unidet3d_tpu_torch.data.synthetic import stripe_superpoints, synthetic_scene

    out = []
    for seed, n, ds in ((0, 2000, 0), (1, 1500, 2)):
        pts = synthetic_scene(n, seed=seed)
        out.append({"points": pts, "dataset_idx": ds, "sp_pts_mask": stripe_superpoints(pts, 20)})
    return out


@pytest.fixture(scope="module")
def forwards():
    """The JAX detector's rulebooks=None eval forward, and the port's forward
    without a pack and on the host pack, from the same variables."""
    from unidet3d_tpu.core.class_table import build_class_table as jax_table
    from unidet3d_tpu.core.config import default_config as jax_config
    from unidet3d_tpu.data.batcher import collate as jax_collate
    from unidet3d_tpu.models.detector import UniDet3DTPU

    from unidet3d_tpu_torch.core.class_table import build_class_table
    from unidet3d_tpu_torch.core.config import DATASETS_CLASSES, default_config
    from unidet3d_tpu_torch.data.batcher import collate, to_device
    from unidet3d_tpu_torch.models.detector import UniDet3D
    from unidet3d_tpu_torch.weights import from_flax, seeded_init_

    samples = _samples()
    jcfg = jax_config(subm_impl="xla", **CAPS)
    model = UniDet3DTPU(cfg=jcfg, table=jax_table(DATASETS_CLASSES))
    jbatch, _, _ = jax_collate(samples, jcfg, training=False, rng=np.random.RandomState(0))
    jbatch = jax.tree_util.tree_map(jnp.asarray, jbatch)
    rngs = {"params": jax.random.PRNGKey(0), "queries": jax.random.PRNGKey(1)}
    variables = jax.jit(lambda: model.init(rngs, jbatch, False))()
    jout, jaux = jax.jit(lambda v, b: model.apply(v, b, False))(variables, jbatch)

    cfg = default_config(**CAPS)
    batch, _, pack = collate(samples, cfg, rng=np.random.RandomState(0))
    net = UniDet3D(cfg, build_class_table(DATASETS_CLASSES), device="cpu")
    net.load_state_dict(from_flax(jax.device_get(variables)))
    tb, tp = to_device(batch, pack, "cpu")
    with torch.no_grad():
        device_pack = net(tb, None)
        host_pack = net(tb, tp)
    seeded = seeded_init_(UniDet3D(cfg, build_class_table(DATASETS_CLASSES), device="cpu"), 0)
    train = [seeded(tb, p, train=True, generator=torch.Generator().manual_seed(3))
             for p in (None, tp)]
    return dict(jax=(jout, jaux), device=device_pack, host=host_pack, train=train, pack=pack)


def test_forward_without_a_pack_equals_the_host_pack_forward(forwards):
    for mode, ((out_d, aux_d), (out_h, aux_h)) in (
            ("eval", (forwards["device"], forwards["host"])), ("train", forwards["train"])):
        for name in ("cls_logits", "boxes"):
            assert torch.equal(getattr(out_d, name), getattr(out_h, name)), (mode, name)
        for name in aux_d._fields:
            assert torch.equal(getattr(aux_d, name), getattr(aux_h, name)), (mode, name)


def test_forward_without_a_pack_matches_jax_rulebooks_none(forwards):
    jout, jaux = forwards["jax"]
    out, aux = forwards["device"]
    valid = np.asarray(jaux.sp_valid)
    np.testing.assert_array_equal(aux.sp_valid.numpy(), valid)
    for name in ("cls_logits", "boxes"):
        ref = np.asarray(getattr(jout, name))
        mine = getattr(out, name).numpy()
        assert mine.shape == ref.shape
        # Valid query rows (padded rows: the TPU kernel's segment semantics
        # against the XLA fallback's key mask, as test_torch_slice.py); fp32,
        # sums in another order through backbone and decoder.
        np.testing.assert_allclose(mine[:, valid], ref[:, valid], rtol=1e-4, atol=1e-4,
                                   err_msg=name)
