"""``evaluate(..., show_dir=...)`` and ``tools/test.py --show-dir`` in the port
on the CPU: one directory per scene named ``<dataset>_scene<k>``, k being the
scene's index in its info file (not the loader's size-sorted order, which the
JAX loop's names follow), the padded slots of the last group not drawn; the
``_points.obj`` / ``_gt.obj`` files byte-equal to the JAX package's
``show_result`` on the same scene (the JAX dataset and test pipeline), the
``_pred.obj`` file byte-equal to it on the kept detections; and under 2 gloo
ranks, each evaluating a strided shard, the names of the two ranks disjoint
and together every scene once, with the one-process run's points and
ground truth.

JAX is imported inside the tests only: the rank workers import this file.
"""
import os
import sys

import numpy as np
import pytest
import torch

from unidet3d_tpu_torch.core.config import default_config
from unidet3d_tpu_torch.core.experiment import DatasetSpec, ExperimentConfig
from unidet3d_tpu_torch.data.synthetic import (
    stripe_superpoints,
    synthetic_scene,
    write_info_dataset,
)
from unidet3d_tpu_torch.train import loop
from unidet3d_tpu_torch.train.metric import IndoorMetric
from unidet3d_tpu_torch.weights import seeded_init_

TINY = dict(max_points=4096, voxel_capacity=4096, max_superpoints=256, max_gts=16,
            num_planes=(8, 16, 24), d_model=32, num_heads=2, hidden_dim=32, num_layers=1,
            query_thr=64, topk_insts=64, compute_dtype="float32")
# Info-file order; the loader visits them largest first, in groups of GROUP,
# the last group padded.
POINTS = (1200, 3000, 1800, 2600, 1500)
GROUP = 2
N_INST = 4
STRIPE = 20


def _scene(name, n, seed):
    pts = synthetic_scene(n, seed=seed)
    sp = stripe_superpoints(pts, STRIPE)
    inst = np.where(sp < 5 * N_INST, sp // 5, -1)
    boxes = []
    for k in range(N_INST):
        lo, hi = pts[inst == k, :3].min(0), pts[inst == k, :3].max(0)
        boxes.append(np.concatenate([(lo + hi) / 2, hi - lo]))
    raw = pts.copy()
    raw[:, 3:] = (pts[:, 3:] + 1) * 127.5
    return dict(name=name, points=raw, super_points=sp, instance_mask=inst,
                boxes=np.asarray(boxes, np.float32), labels=np.arange(N_INST),
                axis_align_matrix=np.eye(4))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("show") / "scannet")
    write_info_dataset(root, [_scene(f"s{i}", n, 7 * i) for i, n in enumerate(POINTS)])
    return root


def _experiment(root):
    return ExperimentConfig(model=default_config(**TINY), eval_batch_size=GROUP,
                            datasets=(DatasetSpec("scannet", root, ann_val="infos.pkl"),))


class RecordingMetric(IndoorMetric):
    """Keeps each scene's boxes and keep mask in the order processed."""

    def __init__(self, *args):
        super().__init__(*args)
        self.scenes = []

    def process(self, didx, boxes, labels, scores, valid, gt_boxes, gt_labels):
        self.scenes.append((np.asarray(boxes), np.asarray(valid, bool)))
        super().process(didx, boxes, labels, scores, valid, gt_boxes, gt_labels)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def shown(root, tmp_path_factory):
    exp = _experiment(root)
    net, _ = loop.build_model(exp, device="cpu")
    seeded_init_(net, 0)
    out = str(tmp_path_factory.mktemp("show_dir"))
    metric = RecordingMetric(exp.model, exp.datasets_classes)
    res = loop.evaluate(exp, net, device="cpu", logger=lambda *a: None, metric=metric,
                        num_threads=1, show_dir=out)
    plain = loop.evaluate(exp, net, device="cpu", logger=lambda *a: None, num_threads=1)
    return dict(dir=out, res=res, plain=plain, scenes=metric.scenes)


def test_one_directory_per_scene_named_by_its_info_index(shown):
    assert sorted(os.listdir(shown["dir"])) == [f"scannet_scene{k:05d}"
                                                for k in range(len(POINTS))]
    # Drawing changes nothing in the metric.
    assert shown["res"] == shown["plain"]
    # 5 scenes in 3 groups of 2: the padded slot was processed once, not drawn.
    assert len(shown["scenes"]) == len(POINTS)


def test_obj_files_equal_the_jax_show_result(shown, root, tmp_path):
    from unidet3d_tpu.core.config import default_config as jax_config
    from unidet3d_tpu.core.experiment import DatasetSpec as JaxSpec
    from unidet3d_tpu.core.experiment import ExperimentConfig as JaxExperiment
    from unidet3d_tpu.train import loop as jax_loop
    from unidet3d_tpu.viz.show_results import show_result as jax_show_result

    jexp = JaxExperiment(model=jax_config(**TINY), eval_batch_size=GROUP,
                         datasets=(JaxSpec("scannet", root, ann_val="infos.pkl"),))
    (ds,) = jax_loop.build_datasets(jexp, "val")
    # The loader's order: largest scene first; the metric saw them so.
    order = np.argsort(-np.asarray(POINTS), kind="stable")
    drawn_preds = 0
    for pos, k in enumerate(order):
        name = f"scannet_scene{k:05d}"
        sample = ds[int(k)]
        gt = np.concatenate([sample["gt_bboxes_3d"],
                             np.zeros((len(sample["gt_bboxes_3d"]), 1), np.float32)], 1)
        boxes, keep = shown["scenes"][pos]
        ref = jax_show_result(str(tmp_path), name, np.asarray(sample["points"], np.float32),
                              gt, boxes[keep])
        mine = os.path.join(shown["dir"], name)
        assert sorted(os.listdir(mine)) == sorted(os.listdir(ref)), name
        for f in os.listdir(ref):
            assert _read(os.path.join(mine, f)) == _read(os.path.join(ref, f)), (name, f)
        drawn_preds += keep.any()
        assert os.path.exists(os.path.join(mine, f"{name}_gt.obj"))
    assert drawn_preds > 0


def test_test_cli_show_dir_equals_evaluate(shown, root, tmp_path, caplog, monkeypatch):
    from unidet3d_tpu_torch.tools import test as test_cli
    from unidet3d_tpu_torch.train.checkpoint import CheckpointManager
    from unidet3d_tpu_torch.train.optim import make_optimizer

    exp = _experiment(root)
    net, _ = loop.build_model(exp, device="cpu")
    seeded_init_(net, 0)
    opt = make_optimizer(net.parameters(), base_lr=1e-4, weight_decay=0.05, total_steps=1,
                         power=0.9, clip_norm=10.0)
    CheckpointManager(str(tmp_path / "ckpt")).save(0, net, opt)
    cfg = tmp_path / "cfg.py"
    cfg.write_text(
        "from unidet3d_tpu_torch.core.config import default_config\n"
        "from unidet3d_tpu_torch.core.experiment import DatasetSpec, ExperimentConfig\n"
        "def get_config():\n"
        f"    return ExperimentConfig(model=default_config(**{TINY!r}), eval_batch_size={GROUP},\n"
        f"        datasets=(DatasetSpec('scannet', {root!r}, ann_val='infos.pkl'),))\n")
    out = tmp_path / "cli_show"
    monkeypatch.setitem(sys.modules, "open3d", None)  # --show without open3d
    with caplog.at_level("WARNING", logger="unidet3d_tpu_torch"):
        res = test_cli.main([str(cfg), str(tmp_path / "ckpt"), "--device", "cpu", "--show",
                             "--show-dir", str(out)])
    assert res == shown["res"]
    # One warning for the 5 scenes, and the evaluation went on.
    assert sum("show disabled" in m for m in caplog.messages) == 1
    for name in os.listdir(shown["dir"]):
        for f in os.listdir(os.path.join(shown["dir"], name)):
            assert _read(out / name / f) == _read(os.path.join(shown["dir"], name, f))
    assert sorted(os.listdir(out)) == sorted(os.listdir(shown["dir"]))


def _show_rank(rank, world, exp, out):
    """One rank: evaluate its shard, drawing into its own directory."""
    net, _ = loop.build_model(exp, device="cpu")
    seeded_init_(net, 0)
    res = loop.evaluate(exp, net, device="cpu", logger=lambda *a: None, num_threads=1,
                        show_dir=os.path.join(out, f"rank{rank}"))
    return dict(res=res, names=sorted(os.listdir(os.path.join(out, f"rank{rank}"))))


def test_two_ranks_draw_disjoint_names_covering_every_scene(shown, root, tmp_path):
    from test_torch_distributed import run_ranks

    exp = _experiment(root)
    ranks = run_ranks(tmp_path, _show_rank, exp, str(tmp_path / "show"))
    names = [set(r["names"]) for r in ranks]
    assert not names[0] & names[1]
    assert sorted(names[0] | names[1]) == sorted(os.listdir(shown["dir"]))
    assert all(names)
    # The points and ground truth are the one-process run's. (The predictions
    # come from other groups, padded to other buckets: fp32 sums in another
    # order.)
    for r, got in enumerate(names):
        for name in got:
            for tag in ("points", "gt"):
                f = f"{name}_{tag}.obj"
                assert _read(tmp_path / "show" / f"rank{r}" / name / f) == _read(
                    os.path.join(shown["dir"], name, f)), (r, name, f)
    # The metric gathers: every rank reports the same results.
    assert ranks[0]["res"] == ranks[1]["res"]
    assert ranks[0]["res"].keys() == shown["res"].keys()
