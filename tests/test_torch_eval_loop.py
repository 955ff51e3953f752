"""The port's eval loop (``unidet3d_tpu_torch/train/loop.py::evaluate``) against
the JAX package's eval path on one CPU device (its ``EvalLoader`` groups,
``make_eval_step`` at each group's bucket, ``predict_batch`` and
``IndoorMetric``, as its ``evaluate`` runs them), on the same on-disk validation sets
(ScanNet and ARKitScenes, groups of 8, buckets, a padded last group) with the
JAX model's weights carried over by ``weights.from_flax``: the same per-scene
detections and the same mAP dict. Then an oracle model that turns each scene's
ground truth into its detections gives mAP 1.0 through the whole loop, and a
padded final group is counted once, and the loop's spans cover each group
once (``wait_s`` their ``eval.wait`` seconds). ``build_model`` /
``build_datasets`` follow the JAX package's."""
import dataclasses
import logging
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unidet3d_tpu.core.config import default_config as jax_config
from unidet3d_tpu.core.experiment import DatasetSpec as JaxSpec
from unidet3d_tpu.core.experiment import ExperimentConfig as JaxExperiment
from unidet3d_tpu.data.batcher import collate as jax_collate
from unidet3d_tpu.data.loader import EvalLoader as JaxEvalLoader
from unidet3d_tpu.models.detector import UniDet3DTPU
from unidet3d_tpu.models.postprocess import predict_batch as jax_predict_batch
from unidet3d_tpu.parallel.train_step import make_eval_step
from unidet3d_tpu.train import loop as jax_loop
from unidet3d_tpu.train.metric import IndoorMetric as JaxMetric
from unidet3d_tpu_torch.core.config import default_config
from unidet3d_tpu_torch.core.experiment import DatasetSpec, ExperimentConfig
from unidet3d_tpu_torch.data.synthetic import (
    stripe_superpoints,
    synthetic_scene,
    write_info_dataset,
)
from unidet3d_tpu_torch.train import loop, profiling
from unidet3d_tpu_torch.train.metric import IndoorMetric
from unidet3d_tpu_torch.weights import from_flax

TINY = dict(max_points=4096, voxel_capacity=4096, max_superpoints=256, max_gts=16,
            num_planes=(8, 16, 24), d_model=32, num_heads=2, hidden_dim=32, num_layers=1,
            query_thr=64, topk_insts=64, compute_dtype="float32")
STRIPE = 20  # points per superpoint stripe
SP_PER_INST = 5  # an instance is a run of 5 stripes
N_INST = 8
SCANNET_POINTS = (1000, 1400, 1800, 2200, 2600, 3000, 3400, 1200, 1600, 3900)  # 2 groups
ARKIT_POINTS = (1500, 2500, 3500)  # 1 group: its test pipeline draws from one RandomState
GROUP = 8


def scene(name, n, seed, arkit):
    """Instances are runs of SP_PER_INST stripe superpoints; instance k has
    label k and its points' bounds as its box (no yaw in ARKitScenes)."""
    pts = synthetic_scene(n, seed=seed)
    sp = stripe_superpoints(pts, STRIPE)
    inst = np.where(sp < N_INST * SP_PER_INST, sp // SP_PER_INST, -1)
    boxes = []
    for k in range(N_INST):
        lo, hi = pts[inst == k, :3].min(0), pts[inst == k, :3].max(0)
        boxes.append(np.concatenate([(lo + hi) / 2, hi - lo] + ([[0.0]] if arkit else [])))
    raw = pts.copy()
    raw[:, 3:] = (pts[:, 3:] + 1) * (0.5 if arkit else 127.5)
    return dict(name=name, points=raw, super_points=sp, instance_mask=inst,
                boxes=np.asarray(boxes, np.float32),
                labels=np.arange(N_INST),
                **({} if arkit else {"axis_align_matrix": np.eye(4)}))


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("eval")
    out = {}
    for name, sizes in (("scannet", SCANNET_POINTS), ("arkitscenes", ARKIT_POINTS)):
        out[name] = str(base / name)
        write_info_dataset(out[name], [scene(f"s{i}", n, 10 * i, name == "arkitscenes")
                                       for i, n in enumerate(sizes)])
    return out


def experiments(roots, names=("scannet", "arkitscenes")):
    kw = dict(eval_batch_size=GROUP)
    mine = ExperimentConfig(model=default_config(**TINY), **kw, datasets=tuple(
        DatasetSpec(n, roots[n], ann_val="infos.pkl") for n in names))
    ref = JaxExperiment(model=jax_config(subm_impl="xla", **TINY), **kw, datasets=tuple(
        JaxSpec(n, roots[n], ann_val="infos.pkl") for n in names))
    return mine, ref


class Recording:
    """Mixin: keeps every scene's whole detection arrays as processed."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.scenes = []

    def process(self, didx, boxes, labels, scores, valid, gt_boxes, gt_labels):
        self.scenes.append(tuple(np.asarray(x) for x in (boxes, labels, scores, valid))
                           + (didx,))
        super().process(didx, boxes, labels, scores, valid, gt_boxes, gt_labels)


class RecordingMetric(Recording, IndoorMetric):
    pass


class JaxRecordingMetric(Recording, JaxMetric):
    pass


def jax_evaluate(jexp, jmodel, variables, metric):
    """The JAX package's evaluate on one device (its non-wire branch):
    EvalLoader groups -> make_eval_step at the group's bucket ->
    predict_batch -> IndoorMetric."""
    steps = {}
    for ds in jax_loop.build_datasets(jexp, "val"):
        didx = ds.dataset_idx
        for samples, batch, _, pack, n_real, cfg_b in JaxEvalLoader(
                ds, jexp.model, GROUP, num_threads=1):
            key = (cfg_b.max_points, cfg_b.max_superpoints)
            if key not in steps:
                steps[key] = make_eval_step(UniDet3DTPU(cfg=cfg_b, table=jmodel.table), cfg_b)
            dev = jax.tree_util.tree_map(jnp.asarray, (batch, pack))
            cls_logits, boxes, qvalid = steps[key](
                variables["params"], variables["batch_stats"], *dev)
            det = jax.tree_util.tree_map(np.asarray, jax_predict_batch(
                cfg_b, didx, cls_logits, boxes, qvalid, dev[0].points, dev[0].valid,
                dev[0].sp_ids))
            for i in range(n_real):
                gt = samples[i]["gt_bboxes_3d"]
                gt = np.concatenate([gt, np.zeros((len(gt), 7 - gt.shape[1]), np.float32)], 1)
                metric.process(didx, det.boxes[i], det.labels[i], det.scores[i],
                               det.valid[i], gt, samples[i]["gt_labels_3d"])
    return metric.compute(logger=None)


@pytest.fixture(scope="module")
def both(roots):
    # ScanNet only: compiling the JAX package's rotated NMS for ARKitScenes
    # would take ~40 s; the oracle below runs ARKitScenes through evaluate.
    exp, jexp = experiments(roots, names=("scannet",))
    jmodel, _ = jax_loop.build_model(jexp)
    ds = jax_loop.build_datasets(jexp, "val")[0]
    jbatch, _, jpack = jax_collate([ds[0]], jexp.model, training=False)
    rngs = {"params": jax.random.PRNGKey(0), "queries": jax.random.PRNGKey(1)}
    variables = jax.jit(lambda: jmodel.init(
        rngs, jax.tree_util.tree_map(jnp.asarray, jbatch), False,
        jax.tree_util.tree_map(jnp.asarray, jpack)))()
    jmetric = JaxRecordingMetric(jexp.model, jexp.datasets_classes)
    ref = jax_evaluate(jexp, jmodel, variables, jmetric)

    net, _ = loop.build_model(exp, device="cpu")
    net.load_state_dict(from_flax(jax.device_get(variables)))
    metric = RecordingMetric(exp.model, exp.datasets_classes)
    mine = loop.evaluate(exp, net, device="cpu", logger=lambda *a: None, metric=metric)
    return dict(ref=ref, mine=mine, ref_scenes=jmetric.scenes, scenes=metric.scenes,
                metric=metric, net=net)


def test_evaluate_gives_the_jax_detections_per_scene(both):
    mine, ref = both["scenes"], both["ref_scenes"]
    assert len(mine) == len(ref) == len(SCANNET_POINTS)
    for i, (m, r) in enumerate(zip(mine, ref)):
        boxes, labels, scores, valid, didx = m
        rboxes, rlabels, rscores, rvalid, rdidx = r
        assert didx == rdidx
        # fp32 on both sides; the ranking of the top-k candidates must agree.
        np.testing.assert_allclose(scores, rscores, rtol=1e-4, atol=1e-6, err_msg=f"scene {i}")
        np.testing.assert_array_equal(labels, rlabels, err_msg=f"scene {i}")
        np.testing.assert_array_equal(valid, rvalid, err_msg=f"scene {i}")
        np.testing.assert_allclose(boxes[valid], rboxes[rvalid], rtol=1e-4, atol=1e-4,
                                   err_msg=f"scene {i}")
        assert valid.any()


def test_evaluate_gives_the_jax_map(both):
    mine, ref = both["mine"], both["ref"]
    assert mine.keys() == ref.keys() == {"scannet"}
    for name in ref:
        assert mine[name].keys() == ref[name].keys()
        for key, value in ref[name].items():
            assert mine[name][key] == pytest.approx(value, abs=1e-9), (name, key)


def test_padded_final_group_counted_once(both):
    metric = both["metric"]
    assert len(metric._gt[0]) == len(metric._dt[0]) == len(SCANNET_POINTS)
    # The ground truth of each scene, once, in the size-sorted order.
    sizes = sorted(SCANNET_POINTS, reverse=True)
    assert [len(g["gt_labels"]) for g in metric._gt[0]] == [N_INST] * len(sizes)
    assert not both["net"].training


class OracleModel(torch.nn.Module):
    """Each superpoint query predicts its instance (a run of SP_PER_INST
    superpoints) with the instance's label at probability 1 and the bounds
    of the instance's points as its box; superpoints outside the instances
    are no object. Through evaluate this turns the ground truth into
    detections."""

    def __init__(self, cfg, n_classes):
        super().__init__()
        self.cfg = cfg
        self.n_classes = n_classes
        self.anchor = torch.nn.Parameter(torch.zeros(1))

    def forward(self, batch, pack):
        b, _ = batch.valid.shape
        s = self.cfg.max_superpoints
        inst = batch.sp_ids.long() // SP_PER_INST
        member = batch.valid & (inst < N_INST)
        pts = batch.points
        idx = torch.where(member, inst, N_INST)[..., None].expand(-1, -1, 3)
        hi = pts.new_full((b, N_INST + 1, 3), -1e9).scatter_reduce(1, idx, pts, "amax")
        lo = pts.new_full((b, N_INST + 1, 3), 1e9).scatter_reduce(1, idx, pts, "amin")
        inst_boxes = torch.cat([(hi + lo) / 2, hi - lo, hi.new_zeros(b, N_INST + 1, 1)], -1)
        q_inst = (torch.arange(s) // SP_PER_INST).clamp(max=N_INST)
        present = torch.zeros(b, s, dtype=torch.bool)
        present.scatter_(1, batch.sp_ids.long(), batch.valid)
        q_valid = present & (q_inst < N_INST)[None]
        # Probability 1 for the label, exactly 0 elsewhere.
        logits = torch.full((b, s, self.n_classes + 1), -1e9)
        label = torch.where(q_inst < N_INST, q_inst, self.n_classes)
        logits[:, torch.arange(s), label] = 0.0
        boxes = inst_boxes[:, q_inst]
        out = types.SimpleNamespace(cls_logits=logits[None], boxes=boxes[None])
        return out, types.SimpleNamespace(query_valid=q_valid)


def test_oracle_through_evaluate_gives_map_one(roots):
    exp, _ = experiments(roots)
    exp = dataclasses.replace(exp, eval_batch_size=4)  # ScanNet's last group padded
    metric = IndoorMetric(exp.model, exp.datasets_classes)
    res = loop.evaluate(exp, OracleModel(exp.model, 17), device="cpu",
                        logger=lambda *a: None, metric=metric)
    assert [len(metric._gt[d]) for d in (0, 5)] == [len(SCANNET_POINTS), len(ARKIT_POINTS)]
    for name, r in res.items():
        classes = exp.datasets_classes[exp.model.datasets.index(name)]
        present = [c for c in classes if f"{c}_AP_0.25" in r]
        assert present == list(classes[:N_INST]), name
        for c in present:
            assert r[f"{c}_AP_0.25"] == pytest.approx(1.0, abs=1e-9), (name, c)
            assert r[f"{c}_AP_0.50"] == pytest.approx(1.0, abs=1e-9), (name, c)
        assert r["mAP_0.25"] == pytest.approx(1.0, abs=1e-9)


class EvalStats(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.stats = []

    def emit(self, record):
        if hasattr(record, "eval_stats"):
            self.stats.append(record.eval_stats)


def test_evaluate_spans_each_group_once(roots):
    exp, _ = experiments(roots)
    exp = dataclasses.replace(exp, eval_batch_size=4)
    logger, handler = logging.getLogger("unidet3d_tpu_torch"), EvalStats()
    level = logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    before = profiling.SPANS.snapshot()
    try:
        loop.evaluate(exp, OracleModel(exp.model, 17), device="cpu", logger=lambda *a: None)
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
    after = profiling.SPANS.snapshot()
    count = {k: c - before.get(k, (0, 0.0))[0] for k, (c, _) in after.items()}
    stats = handler.stats
    assert [(st["dataset"], st["groups"]) for st in stats] == [("scannet", 3), ("arkitscenes", 1)]
    for name in ("eval.wait", "eval.forward", "eval.post", "eval.fetch", "eval.metric"):
        assert count[name] == 4, name
    assert count["eval.open"] == 1 + len(stats)  # the datasets, then each loader
    assert count["eval.compute"] == 1
    # One NMS per scene slot of a group, padded slots too; trimming where the
    # dataset uses superpoints (ScanNet, not ARKitScenes).
    assert count["post.nms"] == 4 * 4
    assert count["post.trim"] == 3 * 4
    assert profiling.SPANS.since(before, after)["eval.wait"] == pytest.approx(
        sum(w for st in stats for w in st["wait_s"]), rel=1e-9, abs=1e-12)
    for st in stats:
        assert len(st["wait_s"]) == st["groups"]
        assert st["span_s"]["eval.wait"] == pytest.approx(sum(st["wait_s"]), rel=1e-9,
                                                          abs=1e-12)
        assert {"eval.open", "eval.forward", "eval.post", "post.nms", "eval.fetch",
                "eval.metric", "loader.pipeline"} <= set(st["span_s"])
        assert "eval.compute" not in st["span_s"]


def test_at_capacities_shares_the_weights(roots):
    exp, _ = experiments(roots)
    net, _ = loop.build_model(exp, device="cpu")
    cfg_b = dataclasses.replace(exp.model, max_points=2048, max_superpoints=128)
    net_b = loop.at_capacities(net, cfg_b)
    assert net_b.cfg == cfg_b and net.cfg == exp.model
    assert all(a is b for a, b in zip(net.parameters(), net_b.parameters()))
    assert loop.at_capacities(net, exp.model) is net


def test_build_datasets_follows_jax(roots):
    exp, jexp = experiments(roots)
    for split in ("train", "val"):
        spec = dataclasses.replace(exp.datasets[0], ann_train="infos.pkl", partition=0.5)
        jspec = dataclasses.replace(jexp.datasets[0], ann_train="infos.pkl", partition=0.5)
        mine = loop.build_datasets(dataclasses.replace(exp, datasets=(spec,), seed=3), split)
        ref = jax_loop.build_datasets(dataclasses.replace(jexp, datasets=(jspec,), seed=3),
                                      split)
        for m, r in zip(mine, ref):
            assert (m.dataset_idx, m.test_mode, m.partition, m.label_mapping, len(m)) == (
                r.dataset_idx, r.test_mode, r.partition, r.label_mapping, len(r))
            assert [getattr(f, "func", f).__name__ for f in m.pipeline] == [
                getattr(f, "func", f).__name__ for f in r.pipeline]
            assert m.rng.get_state()[1].tolist() == r.rng.get_state()[1].tolist()


def test_evaluate_needs_the_models_device(roots):
    exp, _ = experiments(roots)
    net, _ = loop.build_model(exp, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            loop.evaluate(exp, net)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            loop.build_model(exp)
    else:
        with pytest.raises(ValueError, match="model on cpu"):
            loop.evaluate(exp, net)
