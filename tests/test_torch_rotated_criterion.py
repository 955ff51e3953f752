"""The port's criterion on a batch that mixes rotated (ARKitScenes) and
axis-aligned scenes, against the JAX package, on the CPU, fp32: the matcher
costs (the rotated ones only for rotated scenes), the matches, and the total
loss with its gradients with respect to the boxes and the logits.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unidet3d_tpu_torch.losses import criterion as tcrit

NC = 17  # ARKitScenes' classes; the gathered logits carry NC_MAX + 1 = 85 columns
ROTATED = np.array([False, True, False])  # MultiScan, ARKitScenes, MultiScan
TOPK = np.array([3, 3, 3], np.int32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _problem(seed, q=40, g=8, layers=3):
    """Decoder outputs and a SceneGT for ROTATED's scenes: queries near the
    GTs so that matches exist, yaw drawn in [-pi, pi) in rotated scenes and 0
    elsewhere, padded class columns at -1e9, padded queries and GTs."""
    rng = np.random.RandomState(seed)
    b = len(ROTATED)
    gt_boxes = np.concatenate(
        [rng.rand(b, g, 3) * 3, 0.3 + rng.rand(b, g, 3),
         rng.uniform(-np.pi, np.pi, (b, g, 1)) * ROTATED[:, None, None]], -1
    ).astype(np.float32)
    gt_valid = np.ones((b, g), bool)
    gt_valid[1, g - 2:] = False
    owner = rng.randint(0, g, (b, q))
    boxes = np.take_along_axis(gt_boxes, owner[..., None], 1)[None].repeat(layers, 0)
    boxes = boxes + rng.randn(layers, b, q, 7).astype(np.float32) * 0.1
    boxes[..., 3:6] = np.abs(boxes[..., 3:6]) + 0.05
    boxes[..., 6] *= ROTATED[None, :, None]  # the decoder's yaw is 0 unless rotated
    logits = (rng.randn(layers, b, q, 85) * 2).astype(np.float32)
    logits[..., NC:84] = -1e9
    query_valid = np.ones((b, q), bool)
    query_valid[0, q - 5:] = False
    return dict(logits=logits, boxes=boxes.astype(np.float32), query_valid=query_valid,
                labels=rng.randint(0, NC, (b, g)).astype(np.int32), gt_boxes=gt_boxes,
                gt_valid=gt_valid, query_masks=rng.rand(b, g, q) < 0.6)


def _jax_gt(prob, i=None):
    from unidet3d_tpu.losses.criterion import SceneGT

    sel = (lambda x: x) if i is None else (lambda x: x[i])
    return SceneGT(labels=jnp.asarray(sel(prob["labels"])),
                   boxes=jnp.asarray(sel(prob["gt_boxes"])),
                   valid=jnp.asarray(sel(prob["gt_valid"])),
                   query_masks=jnp.asarray(sel(prob["query_masks"])))


def _port_gt(prob):
    return tcrit.SceneGT(labels=_t(prob["labels"]), boxes=_t(prob["gt_boxes"]),
                         valid=_t(prob["gt_valid"]), query_masks=_t(prob["query_masks"]))


@pytest.mark.parametrize("chunk", [128, 16])
def test_pairwise_costs_match_jax(chunk):
    from unidet3d_tpu.losses.criterion import _pairwise_costs_batch

    prob = _problem(0)
    boxes = prob["boxes"][-1]
    ref = np.asarray(_pairwise_costs_batch(jnp.asarray(boxes), jnp.asarray(prob["gt_boxes"]),
                                           jnp.asarray(ROTATED), chunk))
    mine = tcrit.pairwise_costs_batch(_t(boxes), _t(prob["gt_boxes"]),
                                      tuple(np.flatnonzero(ROTATED)), chunk).numpy()
    np.testing.assert_allclose(mine, ref, rtol=1e-5, atol=1e-5)
    # A leading dim (the decoder's output sets) gives each set's costs.
    every = tcrit.pairwise_costs_batch(_t(prob["boxes"]), _t(prob["gt_boxes"]),
                                       tuple(np.flatnonzero(ROTATED)), chunk)
    torch.testing.assert_close(every[-1], torch.from_numpy(mine), rtol=0, atol=1e-6)
    # The rotated scene's costs are not the axis-aligned ones.
    aa = tcrit.pairwise_costs_batch(_t(boxes), _t(prob["gt_boxes"])).numpy()
    assert np.abs(aa[1] - mine[1]).max() > 1e-2
    np.testing.assert_array_equal(aa[[0, 2]], mine[[0, 2]])


def test_match_scene_rotated_outputs_equal():
    from unidet3d_tpu.losses.criterion import match_scene as jax_match

    prob = _problem(1)
    logits, boxes = prob["logits"][-1], prob["boxes"][-1]
    mine = tcrit.match_scene(_t(logits), _t(boxes), _t(prob["query_valid"]),
                             _port_gt(prob), _t(TOPK),
                             rotated_scenes=tuple(np.flatnonzero(ROTATED)))
    for i in range(len(ROTATED)):
        ref = jax_match(jnp.asarray(logits[i]), jnp.asarray(boxes[i]),
                        jnp.asarray(prob["query_valid"][i]), _jax_gt(prob, i),
                        jnp.asarray(ROTATED[i]), jnp.asarray(TOPK[i]))
        for field in ("pair_q", "pair_valid", "cls_target", "has_match"):
            np.testing.assert_array_equal(
                getattr(mine, field)[i].numpy(), np.asarray(getattr(ref, field)),
                err_msg=f"scene {i} {field}")
        assert np.asarray(ref.pair_valid).any()


WEIGHTS = np.array([1.0, 0.7, 1.3], np.float32)


@pytest.fixture(scope="module")
def jax_reference():
    """The JAX criterion's loss and gradients on _problem(2), jitted once."""
    from unidet3d_tpu.losses.criterion import criterion as jax_criterion

    prob = _problem(2)

    def jloss(logits, boxes):
        return jax_criterion(logits, boxes, jnp.asarray(prob["query_valid"]), _jax_gt(prob),
                             jnp.asarray(ROTATED), jnp.asarray(TOPK), jnp.asarray(WEIGHTS))

    ref, (g_logits, g_boxes) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        jnp.asarray(prob["logits"]), jnp.asarray(prob["boxes"]))
    return prob, float(ref), np.asarray(g_logits), np.asarray(g_boxes)


@pytest.mark.parametrize("host_flags", [True, False])
def test_criterion_mixed_batch_total_and_grads_match_jax(jax_reference, host_flags):
    prob, ref, g_logits, g_boxes = jax_reference
    logits = _t(prob["logits"]).requires_grad_(True)
    boxes = _t(prob["boxes"]).requires_grad_(True)
    total = tcrit.criterion(
        logits, boxes, _t(prob["query_valid"]), _port_gt(prob), _t(ROTATED), _t(TOPK),
        _t(WEIGHTS), rotated_scenes=tuple(np.flatnonzero(ROTATED)) if host_flags else None)
    total.backward()
    # fp32 both sides, test_torch_criterion.py's tolerances.
    np.testing.assert_allclose(float(total.detach()), ref, rtol=1e-5)
    np.testing.assert_allclose(logits.grad.numpy(), g_logits, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(boxes.grad.numpy(), g_boxes, rtol=1e-5, atol=1e-6)
    # The rotated scene's yaw gets a gradient; the axis-aligned scenes'
    # gradients are finite (the sanitised rotated branch).
    assert np.abs(boxes.grad.numpy()[:, 1, :, 6]).max() > 0
    assert np.isfinite(boxes.grad.numpy()[:, [0, 2]]).all()
    assert np.isfinite(logits.grad.numpy()).all()


def test_axis_aligned_scenes_finite_on_degenerate_boxes():
    """Padded all-zero boxes in an axis-aligned scene of a mixed batch: the
    rotated branch runs on the stand-in boxes there, so the gradients stay
    finite."""
    prob = _problem(3)
    prob["gt_boxes"][0, 4:] = 0.0
    prob["boxes"][:, 0, :10] = 0.0
    boxes = _t(prob["boxes"]).requires_grad_(True)
    total = tcrit.criterion(_t(prob["logits"]), boxes, _t(prob["query_valid"]),
                            _port_gt(prob), _t(ROTATED), _t(TOPK), _t(np.ones(3, np.float32)),
                            rotated_scenes=(1,))
    total.backward()
    assert torch.isfinite(total) and torch.isfinite(boxes.grad).all()
