"""The port's training loss against the JAX package, on the CPU, fp32: the
axis-aligned DIoU loss, the top-k matcher (equal match indices, ties
included), the ground-truth preparation in both branches, and the criterion
with its gradients.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unidet3d_tpu_torch.losses import criterion as tcrit
from unidet3d_tpu_torch.losses.iou_losses import axis_aligned_diou_loss

NC = 18  # ScanNet's classes; the gathered logits carry NC_MAX + 1 = 85 columns


def _t(x):
    return torch.from_numpy(np.array(x))


def _boxes(rng, n, spread=3.0):
    """(n, 7) center-size boxes, yaw 0."""
    return np.concatenate(
        [rng.rand(n, 3) * spread, 0.2 + rng.rand(n, 3), np.zeros((n, 1))], 1
    ).astype(np.float32)


def _problem(seed, b=2, q=40, g=8, layers=3):
    """Decoder outputs and a SceneGT: queries near the GTs so that matches
    exist, padded class columns at -1e9, padded queries and GTs."""
    rng = np.random.RandomState(seed)
    gt_boxes = np.stack([_boxes(rng, g) for _ in range(b)])
    gt_labels = rng.randint(0, NC, (b, g)).astype(np.int32)
    gt_valid = np.ones((b, g), bool)
    gt_valid[1, g - 2:] = False
    owner = rng.randint(0, g, (b, q))
    boxes = np.take_along_axis(gt_boxes, owner[..., None], 1)[None].repeat(layers, 0)
    boxes = boxes + rng.randn(layers, b, q, 7).astype(np.float32) * 0.1
    boxes[..., 3:6] = np.abs(boxes[..., 3:6]) + 0.05
    boxes[..., 6] = 0.0
    logits = (rng.randn(layers, b, q, 85) * 2).astype(np.float32)
    logits[..., NC:84] = -1e9
    query_valid = np.ones((b, q), bool)
    query_valid[0, q - 5:] = False
    query_masks = rng.rand(b, g, q) < 0.6
    return dict(logits=logits, boxes=boxes.astype(np.float32), query_valid=query_valid,
                labels=gt_labels, gt_boxes=gt_boxes, gt_valid=gt_valid,
                query_masks=query_masks)


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


# ----------------------------------------------------------------- DIoU loss


def test_axis_aligned_diou_loss_values_and_grads():
    from unidet3d_tpu.losses.iou_losses import axis_aligned_diou_loss as jax_diou

    rng = np.random.RandomState(0)
    lo = rng.rand(2, 50, 3).astype(np.float32) * 2
    corners = np.concatenate([lo, lo + 0.1 + rng.rand(2, 50, 3)], -1).astype(np.float32)
    pred, tgt = corners[0], corners[1]
    tgt[:10] = pred[:10] + 0.05  # overlapping pairs
    w = rng.randn(50).astype(np.float32)

    ref, ref_grad = jax.value_and_grad(
        lambda p: jnp.sum(jax_diou(p, jnp.asarray(tgt)) * w))(jnp.asarray(pred))
    tp = _t(pred).requires_grad_(True)
    loss = axis_aligned_diou_loss(tp, _t(tgt))
    (loss * _t(w)).sum().backward()
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(jax_diou(pred, tgt)),
                               rtol=1e-5, atol=1e-6)
    # fp32 both sides, elementwise.
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(ref_grad), rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------------- matcher


@pytest.mark.parametrize("ties", [False, True])
def test_match_scene_outputs_equal(ties):
    from unidet3d_tpu.losses.criterion import match_scene as jax_match

    prob = _problem(1)
    logits, boxes = prob["logits"][-1], prob["boxes"][-1]
    if ties:
        # Queries 2, 3 and 4 sit exactly on GT 0 with its class far ahead:
        # three equal costs, the lowest of GT 0, so the order among equal
        # costs decides pair_q (and the INF costs of the queries GT 0 may not
        # match tie too).
        for i in range(2):
            logits[i, 2:5] = logits[i, 2]
            logits[i, 2:5, prob["labels"][i, 0]] = 10.0
            boxes[i, 2:5] = prob["gt_boxes"][i, 0]
        prob["query_masks"][:, 0, 2:5] = True
    topk = np.array([6, 3], np.int32)  # ScanNet and MultiScan
    mine = tcrit.match_scene(_t(logits), _t(boxes), _t(prob["query_valid"]),
                             _port_gt(prob), _t(topk))
    for i in range(2):
        ref = jax_match(jnp.asarray(logits[i]), jnp.asarray(boxes[i]),
                        jnp.asarray(prob["query_valid"][i]), _jax_gt(prob, i),
                        jnp.asarray(False), jnp.asarray(topk[i]))
        for field in ("pair_q", "pair_valid", "cls_target", "has_match"):
            np.testing.assert_array_equal(
                getattr(mine, field)[i].numpy(), np.asarray(getattr(ref, field)),
                err_msg=f"scene {i} {field}")
        assert np.asarray(ref.pair_valid).any()
    if ties:
        # The stable order: GT 0's first slots are the lowest tied indices.
        first = mine.pair_q[0, 0].tolist()
        assert first[:3] == [2, 3, 4] and mine.pair_valid[0, 0, :3].all()


# -------------------------------------------------------------- prepare_gt


def test_prepare_gt_both_branches_match_jax():
    from unidet3d_tpu.core.config import default_config as jax_config
    from unidet3d_tpu.models.detector import ForwardAux as JaxAux
    from unidet3d_tpu.models.detector import GTBatch as JaxGT
    from unidet3d_tpu.models.detector import PointBatch as JaxBatch
    from unidet3d_tpu.models.detector import prepare_gt as jax_prepare_gt

    from unidet3d_tpu_torch.core.config import default_config
    from unidet3d_tpu_torch.models.detector import ForwardAux, GTBatch, PointBatch, prepare_gt

    rng = np.random.RandomState(4)
    b, p, s, g, q = 2, 500, 48, 8, 30
    geom = (rng.rand(b, p, 3) * 3).astype(np.float32)
    valid = np.ones((b, p), bool)
    valid[1, 420:] = False
    inst = rng.randint(-1, g - 2, (b, p)).astype(np.int32)  # GTs 6, 7 empty
    sp_centers = (rng.rand(b, s, 3) * 3).astype(np.float32)
    sp_valid = np.ones((b, s), bool)
    sp_valid[1, 40:] = False
    query_sp = np.stack([rng.permutation(s)[:q] for _ in range(b)]).astype(np.int32)
    shift = (rng.rand(b, 1, 3) * 0.5).astype(np.float32)
    arrays = dict(
        labels=rng.randint(0, NC, (b, g)).astype(np.int32),
        boxes=np.stack([_boxes(rng, g) for _ in range(b)]),
        valid=np.arange(g)[None].repeat(b, 0) < np.array([[8], [6]]),
        sp_masks=rng.rand(b, g, s) < 0.3,
        inst_ids=inst,
    )
    ds = np.array([0, 2], np.int32)  # ScanNet: masks; MultiScan: distance
    zeros = np.zeros((b, p, 3), np.float32)
    batch_np = dict(points=zeros, vox_src=zeros, features=zeros, valid=valid,
                    sp_ids=np.zeros((b, p), np.int32), dataset_ids=ds)
    aux_np = dict(sp_centers=sp_centers, sp_valid=sp_valid, query_sp=query_sp,
                  query_valid=np.ones((b, q), bool), shift=shift, geom_points=geom)

    ref = jax_prepare_gt(
        jax_config(), JaxBatch(**{k: jnp.asarray(v) for k, v in batch_np.items()}),
        JaxGT(**{k: jnp.asarray(v) for k, v in arrays.items()}),
        JaxAux(**{k: jnp.asarray(v) for k, v in aux_np.items()}))
    mine = prepare_gt(
        default_config(), PointBatch(**{k: _t(v) for k, v in batch_np.items()}),
        GTBatch(**{k: _t(v) for k, v in arrays.items()}),
        ForwardAux(**{k: _t(v) for k, v in aux_np.items()}))
    # Min / max of the same points and one subtraction: exact.
    np.testing.assert_allclose(mine.boxes.numpy(), np.asarray(ref.boxes), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(mine.query_masks.numpy(), np.asarray(ref.query_masks))
    np.testing.assert_array_equal(mine.labels.numpy(), np.asarray(ref.labels))
    # Both branches did something: host masks in scene 0, distance masks in 1.
    assert mine.query_masks[0].any() and mine.query_masks[1].any()
    assert np.all(mine.boxes.numpy()[0, 6:] == 0)  # empty instances


# ----------------------------------------------------------------- criterion


def test_criterion_total_and_grads_match_jax():
    from unidet3d_tpu.losses.criterion import criterion as jax_criterion

    prob = _problem(2)
    b = prob["logits"].shape[1]
    topk = np.array([6, 3], np.int32)
    weights = np.array([1.0, 0.7], np.float32)
    rotated = np.zeros(b, bool)

    def jloss(logits, boxes):
        return jax_criterion(logits, boxes, jnp.asarray(prob["query_valid"]), _jax_gt(prob),
                             jnp.asarray(rotated), jnp.asarray(topk), jnp.asarray(weights))

    ref, (g_logits, g_boxes) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(prob["logits"]), jnp.asarray(prob["boxes"]))
    logits = _t(prob["logits"]).requires_grad_(True)
    boxes = _t(prob["boxes"]).requires_grad_(True)
    total = tcrit.criterion(logits, boxes, _t(prob["query_valid"]), _port_gt(prob),
                            _t(rotated), _t(topk), _t(weights))
    total.backward()
    # fp32 both sides; softmax and DIoU in another order of operations.
    np.testing.assert_allclose(float(total.detach()), float(ref), rtol=1e-5)
    np.testing.assert_allclose(logits.grad.numpy(), np.asarray(g_logits), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(boxes.grad.numpy(), np.asarray(g_boxes), rtol=1e-5, atol=1e-6)
    assert np.abs(np.asarray(g_boxes)).max() > 0


def test_criterion_rotated_scene_not_ported():
    prob = _problem(3)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tcrit.criterion(_t(prob["logits"]), _t(prob["boxes"]), _t(prob["query_valid"]),
                        _port_gt(prob), _t(np.array([False, True])),
                        _t(np.array([6, 3])), _t(np.ones(2, np.float32)))
