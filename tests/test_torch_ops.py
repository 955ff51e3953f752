"""Per-module parity of the port's ops against the JAX package, on the CPU.

Inputs come from numpy seeds and go through both the JAX function and the
port's counterpart (device "cpu", so the CUDA wrappers run their plain
versions). Each comparison states its tolerance.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from unidet3d_tpu_torch.ops.attention import attention_plain, flash_attention_cuda
from unidet3d_tpu_torch.ops.gridpack import build_gridpack_numpy, quantize_points
from unidet3d_tpu_torch.ops.segment import segment_count, segment_mean, segment_sum
from unidet3d_tpu_torch.ops.sparse_conv import inverse_conv, strided_conv, subm_conv
from unidet3d_tpu_torch.ops.subm_conv_cuda import subm_conv_cuda


def _t(x):
    return torch.from_numpy(np.array(x))


def _scene_pack(seed=0, n=3000, batch=2, caps=(4096, 2048, 1024)):
    """Port GridPack (numpy) over `batch` synthetic surface scenes."""
    from unidet3d_tpu_torch.data.synthetic import synthetic_scene

    pts = np.stack([synthetic_scene(n, seed=seed + i)[:, :3] for i in range(batch)])
    valid = np.ones(pts.shape[:2], bool)
    valid[1, n - 200:] = False  # ragged second scene
    bxyz = quantize_points((pts / 0.02).astype(np.float32), valid)
    return bxyz, valid.reshape(-1), caps


# --------------------------------------------------------------- segment ops


@pytest.mark.parametrize("op", ["sum", "mean", "count"])
def test_segment_ops_drop_out_of_range_ids(op):
    from unidet3d_tpu.ops import segment as jseg

    rng = np.random.RandomState(3)
    n, k = 500, 40
    data = rng.randn(n, 5).astype(np.float32)
    # Ids k and beyond are sentinels that both sides must drop.
    ids = rng.randint(0, k + 3, n).astype(np.int32)
    if op == "count":
        mine = segment_count(_t(ids), k)
        ref = jseg.segment_count(jnp.asarray(ids), k)
    else:
        mine = {"sum": segment_sum, "mean": segment_mean}[op](_t(data), _t(ids), k)
        ref = getattr(jseg, f"segment_{op}")(jnp.asarray(data), jnp.asarray(ids), k)
    # fp32 sums of the same values in another order.
    np.testing.assert_allclose(mine.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------ gridpack


@pytest.mark.parametrize("seed", [0, 1])
def test_gridpack_and_quantize_bit_exact(seed):
    from unidet3d_tpu.ops import gridpack as jgp

    rng = np.random.RandomState(seed)
    vox = (rng.rand(2, 700, 3) * 30).astype(np.float32)
    valid = rng.rand(2, 700) > 0.2
    bxyz = quantize_points(vox, valid)
    np.testing.assert_array_equal(bxyz, jgp.quantize_points(vox, valid))
    caps = [1024, 1024, 1024]  # level 0 overflows nothing, levels stay ragged
    mine, counts = build_gridpack_numpy(bxyz, valid.reshape(-1), caps)
    ref, ref_counts = jgp.build_gridpack_numpy(bxyz, valid.reshape(-1), caps)
    np.testing.assert_array_equal(counts, ref_counts)
    np.testing.assert_array_equal(mine.point_inverse, ref.point_inverse)
    for name in ("valid", "neighbors", "parent", "offset_code"):
        for a, b in zip(getattr(mine, name), getattr(ref, name)):
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert mine.n_valid == tuple(int(v.sum()) for v in ref.valid)
    for v, n in zip(mine.valid, mine.n_valid):  # valid voxels are a prefix
        assert v[:n].all() and not v[n:].any()


def test_collate_eval_fields_match_jax():
    from unidet3d_tpu.core.config import default_config as jax_config
    from unidet3d_tpu.data.batcher import collate as jax_collate

    from unidet3d_tpu_torch.core.config import default_config
    from unidet3d_tpu_torch.data.batcher import collate, to_device
    from unidet3d_tpu_torch.data.synthetic import stripe_superpoints, synthetic_scene

    caps = dict(max_points=2048, voxel_capacity=2048, max_superpoints=64)
    samples = []
    for i, n in enumerate([1500, 2600]):  # the second is subsampled
        pts = synthetic_scene(n, seed=10 + i)
        samples.append({"points": pts, "dataset_idx": 2 * i,
                        "sp_pts_mask": stripe_superpoints(pts, 30)})
    batch, pack = collate(samples, default_config(**caps),
                          rng=np.random.RandomState(5))
    jbatch, _, jpack = jax_collate(samples, jax_config(subm_impl="xla", **caps),
                                   training=False, rng=np.random.RandomState(5))
    for name in batch._fields:
        np.testing.assert_array_equal(getattr(batch, name), getattr(jbatch, name),
                                      err_msg=name)
    np.testing.assert_array_equal(pack.point_inverse, jpack.point_inverse)
    for name in ("valid", "neighbors", "parent", "offset_code"):
        for a, b in zip(getattr(pack, name), getattr(jpack, name)):
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)
    tb, tp = to_device(batch, pack, "cpu")
    assert tb.valid.dtype == torch.bool and tp.neighbors[0].dtype == torch.int32
    assert tp.n_valid == pack.n_valid


# --------------------------------------------------------------------- convs


def _conv_inputs(cin, cout, seed=0):
    bxyz, pvalid, caps = _scene_pack(seed)
    pack, _ = build_gridpack_numpy(bxyz, pvalid, caps)
    rng = np.random.RandomState(seed + cin)
    v = caps[0]
    feat = rng.randn(v, cin).astype(np.float32)
    feat[pack.n_valid[0]:] = 0.0  # padding rows carry zeros, as in the model
    w = (rng.randn(27, cin, cout) / np.sqrt(27 * cin)).astype(np.float32)
    return pack, feat, w


@pytest.mark.parametrize("cin,cout", [(6, 32), (32, 32), (64, 32)])
def test_subm_conv_matches_jax_gather_form(cin, cout):
    from unidet3d_tpu.ops.sparse_conv import subm_conv as jax_subm_conv

    pack, feat, w = _conv_inputs(cin, cout)
    nbr = pack.neighbors[0]
    ref = np.asarray(jax_subm_conv(jnp.asarray(feat), jnp.asarray(nbr), jnp.asarray(w)))
    mine = subm_conv_cuda(_t(feat), _t(nbr), _t(w), pack.n_valid[0])
    assert subm_conv_cuda.launches == 0  # CPU tensors: the plain version ran
    # fp32 both sides; 27 products summed in another order.
    np.testing.assert_allclose(mine.numpy(), ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        subm_conv(_t(feat), _t(nbr), _t(w)).numpy()[: pack.n_valid[0]],
        mine.numpy()[: pack.n_valid[0]],
    )


def test_subm_conv_matches_pallas_kernel_interpret():
    """The TPU kernel itself (interpret mode), set up as
    tests/test_pallas_conv.py sets it up."""
    from unidet3d_tpu.ops.pallas_conv import build_banded_rulebook, subm_conv_pallas
    from unidet3d_tpu.ops.sparse_conv import build_subm_neighbors
    from unidet3d_tpu.ops.voxelize import voxelize

    rng = np.random.RandomState(13)
    n, cap, cin, cout = 900, 1024, 8, 16
    bxyz = np.concatenate(
        [rng.randint(0, 2, (n, 1)), rng.randint(0, 14, (n, 3))], axis=1
    ).astype(np.int32)
    grid, vf = voxelize(jnp.array(bxyz), jnp.ones(n, bool), cap,
                        jnp.array(rng.randn(n, cin).astype(np.float32)))
    nbr = np.asarray(build_subm_neighbors(grid))
    w = rng.randn(27, cin, cout).astype(np.float32)
    rb = build_banded_rulebook(nbr, cap, block=128, window=1024)
    ref = np.asarray(subm_conv_pallas(vf, jnp.asarray(rb.bases), jnp.asarray(rb.rel),
                                      jnp.asarray(w), window=1024, interpret=True))
    nv = int(grid.n_voxels)
    mine = subm_conv_cuda(_t(vf), _t(nbr), _t(w), nv).numpy()
    # The Pallas kernel gathers through bf16 one-hot matmuls: the tolerance
    # of tests/test_pallas_conv.py.
    np.testing.assert_allclose(mine[:nv], ref[:nv], rtol=5e-2, atol=1e-1)
    assert not mine[nv:].any()


@pytest.mark.parametrize("level", [0, 1])
def test_strided_and_inverse_conv_match_jax(level):
    from unidet3d_tpu.ops import sparse_conv as jsc

    bxyz, pvalid, caps = _scene_pack(1)
    pack, _ = build_gridpack_numpy(bxyz, pvalid, caps)
    rng = np.random.RandomState(level)
    cin, cout = 16, 24
    n_fine, n_coarse = pack.n_valid[level], pack.n_valid[level + 1]
    fine = rng.randn(caps[level], cin).astype(np.float32)
    coarse = rng.randn(caps[level + 1], cout).astype(np.float32)
    coarse[n_coarse:] = 0.0
    wd = rng.randn(8, cin, cout).astype(np.float32)
    wu = rng.randn(8, cout, cin).astype(np.float32)
    par, code = pack.parent[level], pack.offset_code[level]

    ref_d = np.asarray(jsc.strided_conv(jnp.asarray(fine), jnp.asarray(par),
                                        jnp.asarray(code), caps[level + 1],
                                        jnp.asarray(wd)))
    ref_u = np.asarray(jsc.inverse_conv(jnp.asarray(coarse), jnp.asarray(par),
                                        jnp.asarray(code), jnp.asarray(wu)))
    for n in (None, n_fine):  # all rows, or only the valid prefix
        down = strided_conv(_t(fine), _t(par), _t(code), caps[level + 1], _t(wd), n)
        up = inverse_conv(_t(coarse), _t(par), _t(code), _t(wu), n)
        # fp32 both sides; segment sums in another order.
        np.testing.assert_allclose(down.numpy(), ref_d, rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(up.numpy(), ref_u, rtol=1e-5, atol=1e-4)


# ----------------------------------------------------------------- attention


def _attention_inputs(seed=0, b=2, length=40, h=2, hd=32):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, length, h * hd).astype(np.float32)
    mask = np.ones((b, length), bool)
    mask[0, 31:] = False
    mask[1, 7:] = False
    return x, mask


def test_attention_module_matches_jax_on_valid_rows():
    from unidet3d_tpu.models.decoder import Attention as JaxAttention

    import jax

    from unidet3d_tpu_torch.models.decoder import Attention
    from unidet3d_tpu_torch.weights import from_flax

    x, mask = _attention_inputs()
    jmod = JaxAttention(64, 2, dtype=jnp.float32)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask))
    ref = np.asarray(jmod.apply(variables, jnp.asarray(x), jnp.asarray(mask)))

    mod = Attention(64, 2, torch.float32)
    mod.load_state_dict(from_flax(jax.device_get(variables)))
    seg = torch.where(_t(mask), 1, 2).to(torch.int32)
    mine = mod(_t(x), seg).detach().numpy()
    assert flash_attention_cuda.launches == 0
    # Valid rows only (the JAX XLA path masks keys alone); fp32 softmax.
    np.testing.assert_allclose(mine[mask], ref[mask], rtol=1e-5, atol=1e-5)


def test_attention_plain_segment_semantics():
    """Every query attends exactly to the keys of its own segment, padded
    queries included (the TPU kernel's SegmentIds semantics)."""
    rng = np.random.RandomState(1)
    b, h, length, d = 2, 3, 20, 32
    q, k, v = (rng.randn(b, h, length, d).astype(np.float32) for _ in range(3))
    seg = np.where(rng.rand(b, length) < 0.6, 1, 2).astype(np.int32)
    scale = 1 / np.sqrt(d)
    ref = np.zeros_like(q)
    for bi in range(b):
        for hi in range(h):
            for i in range(length):
                keys = seg[bi] == seg[bi, i]
                s = (k[bi, hi, keys] @ q[bi, hi, i]) * scale
                p = np.exp(s - s.max())
                ref[bi, hi, i] = (p / p.sum()) @ v[bi, hi, keys]
    mine = flash_attention_cuda(_t(q), _t(k), _t(v), _t(seg), scale)
    np.testing.assert_array_equal(mine.numpy(),
                                  attention_plain(_t(q), _t(k), _t(v), _t(seg), scale).numpy())
    # fp32 softmax vs a float32 numpy loop.
    np.testing.assert_allclose(mine.numpy(), ref, rtol=1e-5, atol=1e-5)


# ----------------------------------------------------------- boxes and NMS


def test_face_distances_and_iou_match_jax():
    from unidet3d_tpu.core import boxes as jb
    from unidet3d_tpu.ops import nms as jnms

    from unidet3d_tpu_torch.core.boxes import get_face_distances
    from unidet3d_tpu_torch.ops.nms import pairwise_iou_aa

    rng = np.random.RandomState(2)
    boxes = np.concatenate(
        [rng.rand(50, 3) * 3, 0.3 + rng.rand(50, 3), rng.rand(50, 1) * 3], 1
    ).astype(np.float32)
    pts = (rng.rand(80, 3) * 3).astype(np.float32)
    ref_fd = np.asarray(jb.get_face_distances(jnp.asarray(pts)[:, None],
                                              jnp.asarray(boxes)[None]))
    mine_fd = get_face_distances(_t(pts)[:, None], _t(boxes)[None]).numpy()
    # fp32 rotation: cos/sin and sums rounded differently.
    np.testing.assert_allclose(mine_fd, ref_fd, rtol=1e-5, atol=1e-5)
    ref_iou = np.asarray(jnms.pairwise_iou_aa(jnp.asarray(boxes)))
    np.testing.assert_allclose(pairwise_iou_aa(_t(boxes)).numpy(), ref_iou,
                               rtol=1e-5, atol=1e-6)


def test_greedy_nms_matches_jax():
    from unidet3d_tpu.ops import nms as jnms

    from unidet3d_tpu_torch.ops.nms import greedy_nms, pairwise_iou_aa

    rng = np.random.RandomState(4)
    n = 200
    boxes = np.concatenate(
        [rng.rand(n, 3) * 3, 0.5 + rng.rand(n, 3), np.zeros((n, 1))], 1
    ).astype(np.float32)
    scores = rng.rand(n).astype(np.float32)
    labels = rng.randint(0, 4, n)
    valid = rng.rand(n) > 0.1
    iou = np.asarray(jnms.pairwise_iou_aa(jnp.asarray(boxes)))
    ref = np.asarray(jnms.greedy_nms(jnp.asarray(iou), jnp.asarray(scores),
                                     jnp.asarray(labels), jnp.asarray(valid), 0.3))
    mine = greedy_nms(pairwise_iou_aa(_t(boxes)), _t(scores), _t(labels),
                      _t(valid), 0.3)
    np.testing.assert_array_equal(mine.numpy(), ref)
