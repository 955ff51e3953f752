"""Superpoint box trimming's contract, on the CPU: the port's plain
``trim_boxes_by_superpoints`` (the oracle the card's kernel,
``ops/sp_trim_cuda.py``, is held to in ``tests/test_torch_cuda.py``) against
the JAX package's, bit for bit at yaw 0, on scenes built to hit each edge of
the vote: fractions exactly at the thresholds, invalid points carrying ids,
superpoints with no valid point, boxes left with no point, K not a multiple
of the 128-box chunk. Also what the card's wrapper refuses before any
launch, and that CPU tensors never reach it.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from unidet3d_tpu.core.config import default_config as jax_config
from unidet3d_tpu.models.postprocess import trim_boxes_by_superpoints as jax_trim

from unidet3d_tpu_torch.core.config import default_config
from unidet3d_tpu_torch.models.postprocess import predict_batch, trim_boxes_by_superpoints
from unidet3d_tpu_torch.ops.sp_trim_cuda import sp_trim_cuda

S = 64  # max_superpoints of the cases
LINE_SP = (60, 61)  # the tie cases' superpoints: 100 and 50 points on lines


def line_box(x_lo, x_hi, y):
    """A yaw-0 box over x in (x_lo, x_hi) around the line y = z = `y`."""
    return [(x_lo + x_hi) / 2, y, y, x_hi - x_lo, 0.5, 0.5, 0.0]


def trim_case(case, seed=0):
    """(boxes (K, 7), points (P, 3), valid (P,), sp_ids (P,) int32) of a
    case. Every case has a background of 40 superpoints of 24 random points
    in a 4 m cube and random boxes over it; each case adds its edge."""
    rng = np.random.RandomState(seed)
    centers = rng.rand(40, 3) * 4
    pts = (centers.repeat(24, 0) + rng.randn(40 * 24, 3) * 0.15).astype(np.float32)
    sp = np.arange(40 * 24) // 24
    valid = np.ones(len(pts), bool)
    k = 300 if case == "ragged_k" else 128
    boxes = np.concatenate([rng.rand(k, 3) * 4, 0.2 + rng.rand(k, 3) * 1.5,
                            np.zeros((k, 1))], 1)
    if case == "threshold_ties":
        # 100 points at x = 0..99 (y = z = 10) and 50 at x = 0..49 (y = z = 20):
        # boxes over exactly 81 and 82 of the 100, 9 and 8 of the 50.
        line = np.stack([np.arange(150.0) - np.r_[np.zeros(100), np.full(50, 100.0)],
                         np.r_[np.full(100, 10.0), np.full(50, 20.0)],
                         np.r_[np.full(100, 10.0), np.full(50, 20.0)]], 1)
        pts = np.concatenate([pts, line.astype(np.float32)])
        sp = np.r_[sp, np.full(100, LINE_SP[0]), np.full(50, LINE_SP[1])]
        valid = np.r_[valid, np.ones(150, bool)]
        boxes[:4] = [line_box(-0.5, 80.5, 10.0), line_box(-0.5, 81.5, 10.0),
                     line_box(-0.5, 8.5, 20.0), line_box(-0.5, 7.5, 20.0)]
    elif case == "invalid_points":
        # Invalid slots inside the boxes, carrying the ids of valid
        # superpoints, the sentinel S and ids past it.
        extra = (rng.rand(500, 3) * 4).astype(np.float32)
        pts = np.concatenate([pts, extra])
        sp = np.r_[sp, rng.choice([0, 5, 39, S, S + 7], 500)]
        valid = np.r_[valid, np.zeros(500, bool)]
    elif case == "all_invalid_superpoint":
        # Superpoint 50's points all invalid, in the middle of every box.
        extra = (rng.rand(64, 3) * 0.1 + 2).astype(np.float32)
        pts = np.concatenate([pts, extra])
        sp = np.r_[sp, np.full(64, 50)]
        valid = np.r_[valid, np.zeros(64, bool)]
        boxes[:8, :3] = 2.05
    elif case == "no_inside":
        boxes[:16, :3] += 50.0  # far from every point
    return (boxes.astype(np.float32), pts.astype(np.float32), valid,
            sp.astype(np.int32))


CASES = ("threshold_ties", "invalid_points", "all_invalid_superpoint", "no_inside", "ragged_k")


@pytest.mark.parametrize("case", CASES)
def test_trim_plain_matches_jax(case):
    boxes, pts, valid, sp = trim_case(case)
    keep = np.ones(len(boxes), bool)
    cfg = default_config(max_superpoints=S)
    mine, mine_keep = trim_boxes_by_superpoints(
        cfg, *(torch.from_numpy(x) for x in (boxes, keep, pts, valid, sp)))
    ref, ref_keep = jax_trim(jax_config(max_superpoints=S),
                             *(jnp.asarray(x) for x in (boxes, keep, pts, valid, sp)))
    np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(mine_keep.numpy(), np.asarray(ref_keep))
    assert mine_keep.any() and not mine_keep.all()
    assert torch.all(mine[~mine_keep] == 0)  # no inside point: a zero box
    assert torch.all(mine[:, 6] == 0)

    if case == "threshold_ties":
        # fl32(81 / 100) == fl32(0.81) is not above up_sp_thr: the box keeps
        # its own 81 points; 82 of 100 takes the whole superpoint. 9 of 50
        # is fl32(0.18), not below low_sp_thr: kept; 8 of 50 is dropped.
        assert (cfg.up_sp_thr, cfg.low_sp_thr) == (0.81, 0.18)
        np.testing.assert_array_equal(mine[0, :4].numpy(), [40.0, 10.0, 10.0, 80.0])
        np.testing.assert_array_equal(mine[1, :4].numpy(), [49.5, 10.0, 10.0, 99.0])
        np.testing.assert_array_equal(mine[2, :4].numpy(), [4.0, 20.0, 20.0, 8.0])
        assert not mine_keep[3]
    if case in ("invalid_points", "all_invalid_superpoint"):
        # Invalid points count for nothing: the scene without them trims alike.
        alone = trim_boxes_by_superpoints(cfg, *(torch.from_numpy(x) for x in (
            boxes, keep, pts[valid], valid[valid], sp[valid])))
        assert torch.equal(alone[0], mine) and torch.equal(alone[1], mine_keep)
    if case == "no_inside":
        assert not mine_keep[:16].any()


def test_trim_wrapper_rejects_what_the_kernel_does_not_take():
    """Checked before any build: shapes, dtypes and the device (CPU tensors
    are refused: the plain version is their path)."""
    pts, valid = torch.zeros(1, 10, 3), torch.ones(1, 10, dtype=torch.bool)
    sp, boxes = torch.zeros(1, 10, dtype=torch.int32), torch.zeros(1, 4, 7)
    bad = [
        (pts.double(), valid, sp, boxes),  # points not fp32
        (pts[..., :2], valid, sp, boxes),  # not (B, P, 3)
        (pts, valid.int(), sp, boxes),  # validity not bool
        (pts, valid, sp.long(), boxes),  # ids not int32
        (pts, valid, sp[:, :5], boxes),  # P differs
        (pts, valid, sp, boxes[..., :6]),  # not (B, K, 7)
        (pts, valid, sp, boxes),  # on the CPU
    ]
    launches = sp_trim_cuda.launches
    for args in bad:
        with pytest.raises(ValueError):
            sp_trim_cuda(*args, S, 0.18, 0.81)
    assert sp_trim_cuda.launches == launches


def test_predict_batch_on_cpu_takes_the_plain_trim(monkeypatch):
    """CPU tensors go to the plain version, once per trimmed scene; the
    kernel's wrapper is never called."""
    from unidet3d_tpu_torch.models import postprocess

    calls = []
    plain = postprocess.trim_boxes_by_superpoints
    monkeypatch.setattr(postprocess, "trim_boxes_by_superpoints",
                        lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    boxes, pts, valid, sp = trim_case("ragged_k")
    q = len(boxes)
    logits = np.random.RandomState(1).randn(q, 85).astype(np.float32)
    args = [torch.from_numpy(np.stack([x, x])) for x in
            (logits, boxes, np.ones(q, bool), pts, valid, sp)]
    launches = sp_trim_cuda.launches
    det = predict_batch(default_config(max_superpoints=S), 0, *args)
    assert len(calls) == 2 and sp_trim_cuda.launches == launches
    assert det.boxes.shape == (2, default_config().topk_insts, 7)
