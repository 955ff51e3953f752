"""The port's eval end: ARKitScenes post-processing (rotated NMS, yaw kept)
and the indoor metric (``train/indoor_eval.py``, ``train/metric.py``)
against the JAX package, on the CPU. Detections are drawn so that no IoU
lies within 1e-4 of a threshold, where the two packages' fp32 overlaps could
fall on either side.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from unidet3d_tpu_torch.train import indoor_eval as tie
from unidet3d_tpu_torch.train.metric import IndoorMetric

THRS = (0.25, 0.5)
NC = 3
CLASSES = ["a", "b", "c"]


def _t(x):
    return torch.from_numpy(np.array(x))


def _boxes(rng, n, with_yaw):
    return np.concatenate([rng.rand(n, 3) * 4, 0.4 + rng.rand(n, 3),
                           rng.uniform(-np.pi, np.pi, (n, 1)) * with_yaw], 1)


def _scene(rng, with_yaw):
    """Per class 2 GT boxes and 4 detections: a noisy copy of each GT, a
    second copy of the first (a duplicate) and a false positive, with
    distinct scores. A detection whose IoU with a GT lies within 1e-4 of a
    threshold is drawn again. Every (class, scene) has the same shapes, so
    that the JAX package's eager rotated IoU compiles its ops once."""
    gt = _boxes(rng, 2 * NC, with_yaw)
    noise = np.array([0.15] * 3 + [0.1] * 3 + [0.2 * with_yaw])
    src = np.concatenate([np.arange(2 * NC), np.arange(0, 2 * NC, 2)])
    det = np.concatenate([gt[src] + rng.randn(len(src), 7) * noise,
                          _boxes(rng, NC, with_yaw)])
    det[:, 3:6] = np.abs(det[:, 3:6]) + 0.05
    det = det.astype(np.float32)
    while True:
        iou = tie.box_overlaps(det, gt.astype(np.float32), with_yaw)
        near = (np.abs(iou[..., None] - np.array(THRS)) < 1e-4).any((1, 2))
        if not near.any():
            break
        det[near, :3] += (rng.randn(near.sum(), 3) * 0.01).astype(np.float32)
    labels = np.arange(2 * NC) // 2
    det_labels = np.concatenate([labels[src], np.arange(NC)])
    return dict(gt_boxes=gt.astype(np.float32), gt_labels=labels), dict(
        boxes=det, labels=det_labels, scores=rng.permutation(len(det)) / 100 + 0.01)


def _annos(seed, with_yaw, n_scenes=3):
    rng = np.random.RandomState(seed)
    gts, dts = zip(*(_scene(rng, with_yaw) for _ in range(n_scenes)))
    return list(gts), list(dts)


@pytest.mark.parametrize("with_yaw", [False, True])
def test_indoor_eval_matches_jax(with_yaw):
    from unidet3d_tpu.train.indoor_eval import indoor_eval as jax_indoor_eval

    gts, dts = _annos(0, with_yaw)
    lines = []
    mine = tie.indoor_eval(gts, dts, THRS, CLASSES, with_yaw=with_yaw, logger=lines.append)
    ref = jax_indoor_eval(gts, dts, THRS, CLASSES, with_yaw=with_yaw, logger=None)
    assert mine.keys() == ref.keys()
    # The same matches give the same float64 arithmetic.
    np.testing.assert_allclose([mine[k] for k in ref], [ref[k] for k in ref], rtol=0,
                               atol=1e-12)
    assert 0.0 < mine["mAP_0.50"] < mine["mAP_0.25"] < 1.0
    assert "Overall" in lines[0] and "AP_0.25" in lines[0]


def test_box_overlaps_rotated_matches_jax():
    from unidet3d_tpu.train.indoor_eval import box_overlaps as jax_overlaps

    gts, dts = _annos(1, True, n_scenes=1)
    args = (dts[0]["boxes"], gts[0]["gt_boxes"])
    mine = tie.box_overlaps(*args, with_yaw=True)
    assert mine.shape == (len(args[0]), len(args[1])) and (mine > 0.25).any()
    np.testing.assert_allclose(mine, jax_overlaps(*args, with_yaw=True), rtol=0, atol=1e-5)


def _metrics(jax_cfg, cfg, seed):
    """Both packages' IndoorMetric fed the same scenes of ScanNet (dataset
    0) and ARKitScenes (dataset 5)."""
    from unidet3d_tpu.train.metric import IndoorMetric as JaxMetric

    classes = [CLASSES] * 6
    ours, theirs = IndoorMetric(cfg, classes), JaxMetric(jax_cfg, classes)
    for ds, with_yaw in ((0, False), (5, True)):
        gts, dts = _annos(seed + ds, with_yaw, n_scenes=2)
        for g, d in zip(gts, dts):
            n = len(d["labels"])
            pad = lambda x: np.concatenate([x, np.zeros((2,) + x.shape[1:], x.dtype)])  # noqa: E731
            args = (ds, pad(d["boxes"]), pad(d["labels"]), pad(d["scores"]),
                    np.arange(n + 2) < n, g["gt_boxes"], g["gt_labels"])
            ours.process(*args)
            theirs.process(*args)
    return ours, theirs


def _assert_same_results(mine, ref):
    assert mine.keys() == ref.keys() == {"scannet", "arkitscenes"}
    for name in ref:
        assert mine[name].keys() == ref[name].keys()
        np.testing.assert_allclose([mine[name][k] for k in ref[name]],
                                   [ref[name][k] for k in ref[name]], rtol=0, atol=1e-12)


def test_indoor_metric_compute_matches_jax():
    from unidet3d_tpu.core.config import default_config as jax_config

    from unidet3d_tpu_torch.core.config import default_config

    ours, theirs = _metrics(jax_config(), default_config(), 10)
    ours.gather_across_processes()  # no process group: a no-op
    mine, ref = ours.compute(logger=None), theirs.compute(logger=None)
    _assert_same_results(mine, ref)
    assert mine["arkitscenes"]["mAP_0.25"] > 0


def test_gather_across_processes_merges_like_jax(monkeypatch):
    """all_gather_object stubbed to return this process's payload and a
    second one; the JAX metric's gather stubbed alike."""
    import jax
    import torch.distributed as dist

    from unidet3d_tpu.core.config import default_config as jax_config
    from unidet3d_tpu.train import metric as jax_metric

    from unidet3d_tpu_torch.core.config import default_config

    ours, theirs = _metrics(jax_config(), default_config(), 20)
    other_ours, other_theirs = _metrics(jax_config(), default_config(), 30)

    def all_gather_object(out, obj):
        assert len(out) == 2
        out[:] = [obj, (other_ours._gt, other_ours._dt)]

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    monkeypatch.setattr(dist, "all_gather_object", all_gather_object)
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    monkeypatch.setattr(jax_metric, "_allgather_object",
                        lambda obj: [obj, (other_theirs._gt, other_theirs._dt)])
    ours.gather_across_processes()
    theirs.gather_across_processes()
    assert len(ours._gt[5]) == len(ours._dt[0]) == 4
    _assert_same_results(ours.compute(logger=None), theirs.compute(logger=None))


def test_predict_scene_arkitscenes_matches_jax():
    from unidet3d_tpu.core.config import default_config as jax_config
    from unidet3d_tpu.models.postprocess import predict_scene as jax_predict_scene

    from unidet3d_tpu_torch.core.config import default_config
    from unidet3d_tpu_torch.models.postprocess import predict_batch, predict_scene
    from unidet3d_tpu_torch.ops.nms import pairwise_iou_rotated

    rng = np.random.RandomState(5)
    q, p, ds = 96, 500, 5
    # Queries on 12 objects: each object's queries share its size and yaw up
    # to noise and favour its class, so that class-wise NMS suppresses.
    obj = rng.randint(0, 12, q)
    shapes = np.concatenate([rng.rand(12, 3) * 3, 0.3 + rng.rand(12, 3),
                             rng.uniform(-np.pi, np.pi, (12, 1))], 1)
    boxes = (shapes[obj] + rng.randn(q, 7) * np.array([0.08] * 3 + [0.05] * 3 + [0.1]))
    boxes = boxes.astype(np.float32)
    logits = (rng.randn(q, 85) * 2).astype(np.float32)
    logits[np.arange(q), rng.randint(0, 17, 12)[obj]] += 6.0
    logits[:, 17:84] = -1e9  # ARKitScenes' 17 classes
    inputs = (logits, boxes, rng.rand(q) > 0.1, (rng.rand(p, 3) * 3).astype(np.float32),
              np.ones(p, bool), rng.randint(0, 64, p).astype(np.int32))
    kw = dict(max_superpoints=64, topk_insts=256)
    cfg = default_config(**kw)
    mine = predict_scene(cfg, ds, *(_t(x) for x in inputs))
    ref = jax_predict_scene(jax_config(**kw), ds, *(jnp.asarray(x) for x in inputs))
    # No pair of selected boxes at an IoU within 1e-4 of the NMS threshold.
    iou = pairwise_iou_rotated(mine.boxes).numpy()
    assert not (np.abs(iou - cfg.iou_thr[ds]) < 1e-4).any()
    keep = np.asarray(ref.valid)
    assert 0 < keep.sum() < len(keep)
    np.testing.assert_array_equal(mine.valid.numpy(), keep)
    scored = np.asarray(ref.scores) > 0
    np.testing.assert_array_equal(mine.labels.numpy()[scored], np.asarray(ref.labels)[scored])
    np.testing.assert_allclose(mine.scores.numpy(), np.asarray(ref.scores), rtol=1e-5, atol=1e-7)
    # No superpoint trimming for ARKitScenes: the selected boxes, yaw kept.
    np.testing.assert_allclose(mine.boxes.numpy(), np.asarray(ref.boxes), rtol=1e-6, atol=1e-6)
    assert np.abs(mine.boxes.numpy()[keep, 6]).max() > 0
    batched = predict_batch(cfg, ds, *(_t(x)[None] for x in inputs))
    np.testing.assert_array_equal(batched.valid[0].numpy(), keep)
