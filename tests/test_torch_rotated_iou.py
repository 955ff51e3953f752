"""The port's rotated-box geometry, IoU and DIoU against the JAX package, on
the CPU, fp32: the box helpers, the intersection area, rotated IoU and DIoU
on random pairs and on the JAX package's analytic cases, the rotated DIoU
loss's gradients against jax.grad, and the rotated NMS IoU matrix.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unidet3d_tpu_torch.core import boxes as tboxes
from unidet3d_tpu_torch.losses.iou_losses import rotated_diou_3d_loss
from unidet3d_tpu_torch.ops import rotated_iou as trot

N_PAIRS = 1024


def _t(x):
    return torch.from_numpy(np.array(x))


def _boxes7(rng, n, spread=0.5):
    """(n, 7) boxes around the origin: sizes 0.3-1.8, yaw in [-pi, pi)."""
    return np.concatenate([rng.randn(n, 3) * spread, 0.3 + rng.rand(n, 3) * 1.5,
                           rng.uniform(-np.pi, np.pi, (n, 1))], 1).astype(np.float32)


def _bev(b7):
    return b7[..., [0, 1, 3, 4, 6]]


def test_box_helpers_match_jax():
    from unidet3d_tpu.core import boxes as jboxes

    rng = np.random.RandomState(0)
    b7 = _boxes7(rng, 64)
    angles = b7[:, 6]
    for name, arg in (("rotation_matrix_z", angles), ("box_corners_bev", _bev(b7)),
                      ("boxes7_corners", b7)):
        ref = np.asarray(getattr(jboxes, name)(jnp.asarray(arg)))
        mine = getattr(tboxes, name)(_t(arg)).numpy()
        np.testing.assert_allclose(mine, ref, rtol=1e-6, atol=1e-6, err_msg=name)
    # The port's rotate_points_z is p @ rotation_matrix_z, the JAX convention.
    pts = rng.randn(64, 3).astype(np.float32)
    mine = tboxes.rotate_points_z(_t(pts), _t(angles))
    via = (_t(pts)[:, None, :] @ tboxes.rotation_matrix_z(_t(angles)))[:, 0]
    torch.testing.assert_close(mine, via, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["rotated_intersection_area_2d", "rotated_iou_3d",
                                  "diff_diou_rotated_3d"])
def test_rotated_ops_match_jax_on_random_pairs(name):
    from unidet3d_tpu.ops import rotated_iou as jrot

    rng = np.random.RandomState(1)
    a, b = _boxes7(rng, N_PAIRS), _boxes7(rng, N_PAIRS)
    b[:64] = a[:64]  # identical pairs
    b[64:128, 6] = a[64:128, 6]  # same yaw
    if name == "rotated_intersection_area_2d":
        a, b = _bev(a), _bev(b)
    ref = np.asarray(getattr(jrot, name)(jnp.asarray(a), jnp.asarray(b)))
    mine = getattr(trot, name)(_t(a), _t(b)).numpy()
    assert mine.shape == (N_PAIRS,)
    np.testing.assert_allclose(mine, ref, rtol=0, atol=1e-5)
    assert (ref > 0).mean() > 0.2  # most pairs overlap


# The JAX package's analytic cases (tests/test_rotated_iou.py): (function,
# box a, box b, expected).
_OCTAGON = 2 * (np.sqrt(2) - 1)
ANALYTIC = [
    ("rotated_intersection_area_2d", [1.0, 2.0, 3.0, 4.0, 0.3], [1.0, 2.0, 3.0, 4.0, 0.3], 12.0),
    ("rotated_intersection_area_2d", [0.0, 0.0, 1.0, 1.0, 0.0], [10.0, 0.0, 1.0, 1.0, 0.5], 0.0),
    ("rotated_intersection_area_2d", [0.0, 0.0, 1.0, 1.0, 0.0], [0.5, 0.0, 1.0, 1.0, 0.0], 0.5),
    ("rotated_intersection_area_2d", [0.0, 0.0, 1.0, 1.0, 0.0],
     [0.0, 0.0, 1.0, 1.0, np.pi / 4], _OCTAGON),
    ("rotated_intersection_area_2d", [0.0, 0.0, 4.0, 4.0, 0.2], [0.0, 0.0, 1.0, 1.0, 1.0], 1.0),
    ("rotated_iou_3d", [[1.0, 2.0, 3.0, 2.0, 3.0, 4.0, 0.7]],
     [[1.0, 2.0, 3.0, 2.0, 3.0, 4.0, 0.7]], [1.0]),
    ("rotated_iou_3d", [[0.0, 0.0, 0.0, 2.0, 2.0, 2.0, 0.0]],
     [[1.0, 1.0, 1.0, 2.0, 2.0, 2.0, 0.0]], [1.0 / 15.0]),
    ("diff_diou_rotated_3d", [[0.0, 0.0, 0.0, 2.0, 2.0, 2.0, 0.5]],
     [[0.0, 0.0, 0.0, 2.0, 2.0, 2.0, 0.5]], [1.0]),
]


@pytest.mark.parametrize("name, a, b, expected", ANALYTIC)
def test_analytic_cases(name, a, b, expected):
    from unidet3d_tpu.ops import rotated_iou as jrot

    a, b = np.float32(a), np.float32(b)
    mine = getattr(trot, name)(_t(a), _t(b)).numpy()
    np.testing.assert_allclose(mine, expected, rtol=1e-4, atol=1e-6)
    ref = np.asarray(getattr(jrot, name)(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(mine, ref, rtol=0, atol=1e-5)


def _well_separated(a, b, sep=1e-4):
    """Pairs whose valid candidate vertices are all more than `sep` apart
    (and no corner within `sep` of the other box's boundary): there the sort
    and the validity masks cannot flip between two fp32 implementations."""
    ca, cb = tboxes.box_corners_bev(_t(_bev(a))), tboxes.box_corners_bev(_t(_bev(b)))
    pts, valid = trot._edge_intersections(ca, cb)
    verts = torch.cat([pts, ca, cb], -2)
    grow = _t(np.float32([0, 0, 2 * sep, 2 * sep, 0]))
    in_a = trot._points_in_rotated_box(cb, _t(_bev(a)) + grow)
    in_b = trot._points_in_rotated_box(ca, _t(_bev(b)) + grow)
    shrunk_a = trot._points_in_rotated_box(cb, _t(_bev(a)) - grow)
    shrunk_b = trot._points_in_rotated_box(ca, _t(_bev(b)) - grow)
    valid = torch.cat([valid, trot._points_in_rotated_box(ca, _t(_bev(b))),
                       trot._points_in_rotated_box(cb, _t(_bev(a)))], -1)
    d = (verts[:, :, None] - verts[:, None, :]).norm(dim=-1)
    both = valid[:, :, None] & valid[:, None, :] & ~torch.eye(24, dtype=torch.bool)
    close = (both & (d <= sep)).any((1, 2))
    edge = (in_a != shrunk_a).any(-1) | (in_b != shrunk_b).any(-1)
    return (~close & ~edge).numpy()


def test_rotated_diou_loss_gradients_match_jax():
    from unidet3d_tpu.losses.iou_losses import rotated_diou_3d_loss as jax_loss

    rng = np.random.RandomState(2)
    a, b = _boxes7(rng, 2 * N_PAIRS), _boxes7(rng, 2 * N_PAIRS)
    keep = _well_separated(a, b)
    a, b = a[keep][:N_PAIRS], b[keep][:N_PAIRS]
    assert len(a) == N_PAIRS
    w = rng.randn(N_PAIRS).astype(np.float32)
    ga, gb = jax.grad(lambda x, y: jnp.sum(jax_loss(x, y) * w), argnums=(0, 1))(
        jnp.asarray(a), jnp.asarray(b))
    ta, tb = _t(a).requires_grad_(True), _t(b).requires_grad_(True)
    (rotated_diou_3d_loss(ta, tb) * _t(w)).sum().backward()
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(ga), rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(gb), rtol=1e-3, atol=1e-5)
    assert np.abs(np.asarray(ga)[:, 6]).max() > 1e-3  # the yaw gets a gradient


def test_identical_boxes_give_finite_gradients():
    """Identical boxes: every corner is also an edge crossing, so candidates
    come in equal pairs; the stable sort picks the first and the gradient
    stays finite."""
    rng = np.random.RandomState(3)
    a = _boxes7(rng, 64)
    a[:8, 6] = 0.0  # parallel edges too
    ta, tb = _t(a).requires_grad_(True), _t(a.copy()).requires_grad_(True)
    loss = rotated_diou_3d_loss(ta, tb)
    loss.sum().backward()
    np.testing.assert_allclose(loss.detach().numpy(), 0.0, atol=1e-5)
    assert torch.isfinite(ta.grad).all() and torch.isfinite(tb.grad).all()


def test_pairwise_iou_rotated_chunks_jax_and_zero_yaw():
    from unidet3d_tpu.ops.nms import pairwise_iou_rotated as jax_pairwise

    from unidet3d_tpu_torch.ops.nms import pairwise_iou_aa, pairwise_iou_rotated

    rng = np.random.RandomState(4)
    boxes = _boxes7(rng, 200, spread=1.0)
    mine = pairwise_iou_rotated(_t(boxes))
    assert mine.shape == (200, 200)
    torch.testing.assert_close(pairwise_iou_rotated(_t(boxes), chunk=48), mine,
                               rtol=0, atol=1e-6)
    ref = np.asarray(jax_pairwise(jnp.asarray(boxes)))
    np.testing.assert_allclose(mine.numpy(), ref, rtol=0, atol=1e-5)
    # At yaw 0 the rotated IoU is the axis-aligned one.
    boxes[:, 6] = 0.0
    torch.testing.assert_close(pairwise_iou_rotated(_t(boxes)), pairwise_iou_aa(_t(boxes)),
                               rtol=0, atol=1e-5)
