"""The port's eval forward against the JAX package's, as a whole, at the full
production width (num_planes (32..160), 6 decoder layers, d_model 256,
8 heads, hidden 1024) on a small scene: 4096 points, S = 512.

JAX runs ``model.init`` + ``apply`` with the XLA conv path and fp32 compute;
its variables go through ``weights.from_flax`` into the port, which runs the
same scene on the CPU (the kernels' plain versions). Both sides collate the
same sample with their own code.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

N_POINTS = 4096
S = 512


def _sample():
    from unidet3d_tpu_torch.data.synthetic import stripe_superpoints, synthetic_scene

    pts = synthetic_scene(N_POINTS, seed=0)
    return {"points": pts, "dataset_idx": 0, "sp_pts_mask": stripe_superpoints(pts, 64)}


@pytest.fixture(scope="module")
def both():
    from unidet3d_tpu.core.config import default_config as jax_config
    from unidet3d_tpu.core.experiment import DatasetSpec, ExperimentConfig
    from unidet3d_tpu.data.batcher import collate as jax_collate
    from unidet3d_tpu.tools.record_activations import record_activations
    from unidet3d_tpu.train.loop import build_model

    from unidet3d_tpu_torch.core.class_table import build_class_table
    from unidet3d_tpu_torch.core.config import DATASETS_CLASSES, default_config
    from unidet3d_tpu_torch.data.batcher import collate, to_device
    from unidet3d_tpu_torch.models.detector import UniDet3D
    from unidet3d_tpu_torch.weights import from_flax

    caps = dict(max_points=N_POINTS, voxel_capacity=N_POINTS, max_superpoints=S,
                compute_dtype="float32")
    exp = ExperimentConfig(
        model=jax_config(subm_impl="xla", **caps),
        datasets=(DatasetSpec(name="scannet", data_root="."),),
    )
    model, _ = build_model(exp)
    sample = _sample()
    jbatch_np, _, jpack_np = jax_collate([sample], exp.model, training=False,
                                         rng=np.random.RandomState(0))
    jbatch = jax.tree_util.tree_map(jnp.asarray, jbatch_np)
    jpack = jax.tree_util.tree_map(jnp.asarray, jpack_np)
    rngs = {"params": jax.random.PRNGKey(0), "queries": jax.random.PRNGKey(1)}
    variables = jax.jit(lambda: model.init(rngs, jbatch, False, jpack))()
    rec = record_activations(model, variables, jbatch, jpack)

    cfg = default_config(**caps)
    batch_np, pack_np = collate([sample], cfg, rng=np.random.RandomState(0))
    net = UniDet3D(cfg, build_class_table(DATASETS_CLASSES), device="cpu")
    net.load_state_dict(from_flax(jax.device_get(variables)))
    captured = {}
    net.backbone.register_forward_hook(
        lambda mod, args, out: captured.__setitem__("backbone", out)
    )
    out, aux = net(*to_device(batch_np, pack_np, "cpu"))
    return dict(
        rec=rec, out=out, aux=aux, backbone=captured["backbone"],
        jbatch=jbatch_np, jpack=jpack_np, batch=batch_np, pack=pack_np,
    )


def test_slice_collates_the_same_inputs(both):
    for name in ("points", "vox_src", "features", "valid", "sp_ids", "dataset_ids"):
        np.testing.assert_array_equal(
            getattr(both["batch"], name), getattr(both["jbatch"], name), err_msg=name
        )
    for name in ("valid", "neighbors", "parent", "offset_code"):
        for mine, ref in zip(getattr(both["pack"], name), getattr(both["jpack"], name)):
            np.testing.assert_array_equal(mine, np.asarray(ref), err_msg=name)


def test_slice_backbone_matches(both):
    ref = both["rec"]["inter/backbone/__call__/0"]
    # fp32 on both sides, sums taken in another order through 37 convs:
    # relative error of a few 1e-6 per conv, compounded.
    np.testing.assert_allclose(both["backbone"].numpy(), ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("field", ["cls_logits", "boxes"])
def test_slice_outputs_match_on_valid_queries(both, field):
    ref = both["rec"][f"out/{field}"]  # (7, B, Q, ...)
    mine = getattr(both["out"], field).numpy()
    valid = both["rec"]["aux/sp_valid"]
    assert mine.shape == ref.shape
    # Valid query rows only: on padded rows the JAX XLA attention masks keys
    # alone while the port keeps the TPU kernel's segment semantics. fp32
    # throughout; tolerance covers summation order through backbone+decoder.
    np.testing.assert_allclose(mine[:, valid], ref[:, valid], rtol=1e-3, atol=1e-3)


def test_slice_aux_matches(both):
    rec, aux = both["rec"], both["aux"]
    np.testing.assert_array_equal(aux.sp_valid.numpy(), rec["aux/sp_valid"])
    # Segment means of raw fp32 coordinates: summation order only.
    np.testing.assert_allclose(aux.sp_centers.numpy(), rec["aux/sp_centers"],
                               rtol=1e-5, atol=1e-5)
