"""The port's training step against the JAX package's, as a whole, on the CPU
in fp32: collate with ground truth -> forward (train) -> detection_loss ->
backward -> clip + AdamW, at reduced widths (num_planes (8, 16, 24),
2 decoder layers, d_model 64, 2 heads, hidden 64).

Two scenes of 2,000 points: one with ScanNet's flags (boxes from instance
masks, host superpoint masks) and one with MultiScan's (raw boxes, distance
top-k masks). S = 128, G = 16 and query_thr 48, below both scenes'
superpoint counts, so that the random query selection matters. The JAX query
noise (detector.py's fold_in / uniform per scene) is computed here and
injected into the port. JAX's variables go into the port through
``weights.from_flax``, and so do its gradients and updated batch statistics,
so that every tensor is compared by name.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as nn

N_POINTS = 2000
SP_SIZE = 20  # points per stripe superpoint: 100 superpoints per scene
CAPS = dict(max_points=2048, voxel_capacity=2048, max_superpoints=128, max_gts=16,
            query_thr=48, compute_dtype="float32", num_planes=(8, 16, 24),
            num_layers=2, d_model=64, num_heads=2, hidden_dim=64)


def _sample(seed, dataset_idx, n_classes, rotated=False):
    """A synthetic scene with instances made of runs of 5 consecutive stripe
    superpoints, boxes at their points' bounds (with `rotated`, each given a
    yaw drawn uniformly in [-pi, pi))."""
    from unidet3d_tpu_torch.data.synthetic import stripe_superpoints, synthetic_scene

    rng = np.random.RandomState(seed)
    pts = synthetic_scene(N_POINTS, seed=seed)
    sp = stripe_superpoints(pts, SP_SIZE)
    n_sp = int(sp.max()) + 1
    n_inst = 12
    inst_of_sp = np.full(n_sp, -1)
    inst_of_sp[: 5 * n_inst] = np.arange(5 * n_inst) // 5
    inst = inst_of_sp[sp]
    boxes = np.stack([np.concatenate([(pts[inst == k, :3].max(0) + pts[inst == k, :3].min(0)) / 2,
                                      pts[inst == k, :3].max(0) - pts[inst == k, :3].min(0)])
                      for k in range(n_inst)]).astype(np.float32)
    labels = rng.randint(0, n_classes, n_inst)
    if rotated:
        yaw = rng.uniform(-np.pi, np.pi, (n_inst, 1)).astype(np.float32)
        boxes = np.concatenate([boxes, yaw], 1)
    return {"points": pts, "dataset_idx": dataset_idx, "sp_pts_mask": sp,
            "gt_bboxes_3d": boxes,
            "gt_labels_3d": labels,
            "gt_sp_masks": inst_of_sp[None, :] == np.arange(n_inst)[:, None],
            "pts_instance_mask": inst}


class _QueryRng(nn.Module):
    """Draws the detector's first "queries" rng in the root scope, as
    UniDet3DTPU.__call__ does."""

    @nn.compact
    def __call__(self):
        return self.make_rng("queries")


def _perturb(variables, seed):
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        x = np.asarray(x)
        if path[-1].key == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return (x + 0.05 * rng.randn(*x.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, jax.device_get(variables))


def run_both(samples):
    """One training step of the JAX package and of the port on `samples`,
    from the same variables and the same query draw; the port's step is
    told the batch's dataset ids on the host."""
    from unidet3d_tpu.core.class_table import build_class_table as jax_table
    from unidet3d_tpu.core.config import default_config as jax_config
    from unidet3d_tpu.data.batcher import collate as jax_collate
    from unidet3d_tpu.models.detector import UniDet3DTPU, detection_loss as jax_loss

    from unidet3d_tpu_torch.core.class_table import build_class_table
    from unidet3d_tpu_torch.core.config import DATASETS_CLASSES, default_config
    from unidet3d_tpu_torch.data.batcher import collate, gt_to_device, to_device
    from unidet3d_tpu_torch.models.detector import UniDet3D
    from unidet3d_tpu_torch.parallel.train_step import make_train_step
    from unidet3d_tpu_torch.train.optim import make_optimizer
    from unidet3d_tpu_torch.weights import from_flax

    jcfg = jax_config(subm_impl="xla", **CAPS)
    model = UniDet3DTPU(cfg=jcfg, table=jax_table(DATASETS_CLASSES))
    jbatch, jgt, jpack = jax.tree_util.tree_map(
        jnp.asarray, jax_collate(samples, jcfg, training=True,
                                 rng=np.random.RandomState(0)))
    variables = jax.jit(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "queries": jax.random.PRNGKey(1)},
        jbatch, False, jpack))()
    variables = _perturb(variables, 1)
    key = jax.random.PRNGKey(7)

    def loss_fn(params):
        (out, aux), mut = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jbatch, True, jpack, rngs={"queries": key}, mutable=["batch_stats"])
        return jax_loss(jcfg, out, aux, jbatch, jgt), (mut["batch_stats"], aux.query_sp)

    (loss, (stats, query_sp)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    # detector.py: fold_in(make_rng("queries"), scene) -> uniform((S,)).
    rng = _QueryRng().apply({}, rngs={"queries": key})
    keys = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(rng, jnp.arange(len(samples)))
    noise = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (CAPS["max_superpoints"],)))(keys))

    cfg = default_config(**CAPS)
    batch, gt, pack = collate(samples, cfg, rng=np.random.RandomState(0))
    net = UniDet3D(cfg, build_class_table(DATASETS_CLASSES), device="cpu")
    net.load_state_dict(from_flax(variables))
    opt = make_optimizer(net.parameters())
    step = make_train_step(net, cfg, opt)
    tb, tp = to_device(batch, pack, "cpu")
    captured = {}
    hook = net.register_forward_hook(
        lambda mod, args, out: captured.__setitem__("query_sp", out[1].query_sp))
    metrics = step(tb, gt_to_device(gt, "cpu"), tp, query_noise=torch.from_numpy(noise),
                   host_dataset_ids=batch.dataset_ids)
    hook.remove()
    return dict(loss=float(loss), grads=from_flax({"params": jax.device_get(grads)}),
                stats=from_flax({"batch_stats": jax.device_get(stats)}),
                query_sp=np.asarray(query_sp), net=net, metrics=metrics,
                port_query_sp=captured["query_sp"].numpy(), samples=samples,
                batch=batch, gt=gt, jgt=jax.device_get(jgt))


@pytest.fixture(scope="module")
def both():
    return run_both([_sample(0, 0, 18), _sample(1, 2, 17)])  # ScanNet, MultiScan


def test_train_collate_matches_jax(both):
    for name in both["gt"]._fields:
        np.testing.assert_array_equal(getattr(both["gt"], name),
                                      np.asarray(getattr(both["jgt"], name)), err_msg=name)
    assert both["gt"].valid.sum() == 24


def test_train_step_draws_the_same_queries(both):
    np.testing.assert_array_equal(both["port_query_sp"], both["query_sp"])
    assert both["query_sp"].shape == (2, CAPS["query_thr"])


def test_train_step_loss_matches(both):
    loss = float(both["metrics"]["loss"])
    assert np.isfinite(loss) and loss > 0
    # fp32 both sides; sums in another order through backbone and decoder.
    np.testing.assert_allclose(loss, both["loss"], rtol=1e-4)


def test_train_step_gradients_match_by_name(both):
    named = dict(both["net"].named_parameters())
    assert set(named) == set(both["grads"])
    norm = float(both["metrics"]["grad_norm"])
    ref_norm = float(np.sqrt(sum((g.double() ** 2).sum() for g in both["grads"].values())))
    np.testing.assert_allclose(norm, ref_norm, rtol=1e-4)
    # The step clipped .grad in place by 10 / |g| where |g| >= 10.
    unclip = max(1.0, norm / 10.0)
    for name, ref in both["grads"].items():
        mine = named[name].grad * unclip
        # fp32; the conv backward sums in another order (mirrored conv and
        # per-offset weight gradients against XLA's transposed gathers).
        err = (mine - ref).abs().max().item()
        assert err <= 1e-3 * ref.abs().max().item() + 1e-6, (name, err)


def test_train_step_updates_batch_stats_like_jax(both):
    buffers = dict(both["net"].named_buffers())
    assert both["stats"]
    for name, ref in both["stats"].items():
        # Masked fp32 moments of the same rows.
        torch.testing.assert_close(buffers[name], ref, rtol=1e-4, atol=1e-5,
                                   msg=name)
