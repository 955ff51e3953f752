"""The port's checkpoint-parity tools on the CPU:

  * ``tools/convert_mmdet3d_infos.py``: ``convert_infos`` / ``convert_entry``
    give the JAX package's output on the same v2 pkl;
  * ``tools/parity_eval.py``: exit code 2 without a checkpoint and without
    val infos; on a synthetic reference checkpoint
    (``data/synthetic.py::reference_state_dict``, narrow widths) over a
    synthetic ScanNet val set whose infos exist only in mmdet3d-v2 form under
    ``mmdet3d/``, the re-anchor path writes the port-format infos, and with
    random weights the run prints the delta table and exits 1 at the default
    tolerance and 0 at a tolerance above 100. The table's row is the JAX
    tool's format on the mAP that ``evaluate`` gives the converted weights.
"""
import copy
import dataclasses
import os
import pickle

import numpy as np
import pytest

from unidet3d_tpu.tools.convert_mmdet3d_infos import convert_entry as jax_convert_entry
from unidet3d_tpu.tools.convert_mmdet3d_infos import convert_infos as jax_convert_infos
from unidet3d_tpu_torch.tools import parity_eval
from unidet3d_tpu_torch.tools.convert_mmdet3d_infos import convert_entry, convert_infos

V2 = {
    "metainfo": {"categories": {"chair": 0}},
    "data_list": [
        {
            "lidar_points": {"lidar_path": "scene0.bin", "num_pts_feats": 6},
            "pts_semantic_mask_path": "scene0.bin",
            "pts_instance_mask_path": "scene0.bin",
            "super_pts_path": "scene0.bin",
            "axis_align_matrix": np.eye(4),
            "instances": [
                {"bbox_3d": [0, 0, 0, 1, 1, 1], "bbox_label_3d": 3},
                {"bbox_3d": [0.5, 0, 0, 1, 2, 1, 0.3], "bbox_label_3d": -1},
                {"bbox_3d": np.float32([1, 2, 3, 1, 1, 1]), "bbox_label_3d": np.int64(5)},
            ],
        },
        {  # ARKitScenes-style: no masks, no super_pts_path, deeper paths
            "lidar_points": {"lidar_path": "a/b/41069021_point.bin"},
            "instances": [],
        },
    ],
}


def test_convert_infos_equals_jax(tmp_path):
    src = tmp_path / "v2.pkl"
    with open(src, "wb") as f:
        pickle.dump(V2, f)
    mine = convert_infos(str(src), str(tmp_path / "mine" / "ours.pkl"))
    ref = jax_convert_infos(str(src), str(tmp_path / "ref" / "ours.pkl"))
    assert mine == ref
    with open(tmp_path / "mine" / "ours.pkl", "rb") as f:
        assert pickle.load(f) == ref
    for entry in V2["data_list"]:
        assert convert_entry(copy.deepcopy(entry)) == jax_convert_entry(copy.deepcopy(entry))
    e0, e1 = mine["data_list"]
    assert e0["lidar_points"]["lidar_path"] == "points/scene0.bin"
    assert len(e0["instances"]) == 2  # label -1 dropped
    assert e1["super_pts_path"] == "super_points/41069021_point.bin"


def test_convert_infos_rejects_v1(tmp_path):
    src = tmp_path / "v1.pkl"
    with open(src, "wb") as f:
        pickle.dump({"infos": []}, f)
    with pytest.raises(ValueError, match="not a v2 info pkl"):
        convert_infos(str(src), str(tmp_path / "out.pkl"))


PLANES = (8, 16)
D_MODEL, HEADS, LAYERS = 32, 2, 1
TINY = dict(max_points=4096, voxel_capacity=4096, max_superpoints=256, max_gts=16,
            num_planes=PLANES, d_model=D_MODEL, num_heads=HEADS, hidden_dim=4 * D_MODEL,
            num_layers=LAYERS, query_thr=64, topk_insts=64, compute_dtype="float32")
CONFIG = """
from unidet3d_tpu_torch.core.config import default_config
from unidet3d_tpu_torch.core.experiment import DatasetSpec, ExperimentConfig


def get_config():
    return ExperimentConfig(
        model=default_config(**{tiny!r}), eval_batch_size=2,
        datasets=(DatasetSpec("scannet", {root!r}, ann_val="infos_val.pkl"),
                  DatasetSpec("multiscan", {missing!r}, ann_val="infos_val.pkl")))
"""
FLAGS = ["--planes", *map(str, PLANES), "--d-model", str(D_MODEL), "--layers", str(LAYERS),
         "--device", "cpu"]


def _v2_dataset(root):
    """Three ScanNet scenes whose infos are only in mmdet3d-v2 form: bare
    file names under root/mmdet3d/infos_val.pkl."""
    from unidet3d_tpu_torch.data.synthetic import stripe_superpoints, synthetic_scene
    from unidet3d_tpu_torch.data.synthetic import write_info_dataset

    scenes = []
    for i, n in enumerate((1500, 2500, 2000)):
        pts = synthetic_scene(n, seed=i)
        sp = stripe_superpoints(pts, 20)
        inst = np.where(sp < 20, sp // 5, -1)
        boxes = [np.concatenate([(pts[inst == k, :3].min(0) + pts[inst == k, :3].max(0)) / 2,
                                 pts[inst == k, :3].max(0) - pts[inst == k, :3].min(0)])
                 for k in range(4)]
        raw = pts.copy()
        raw[:, 3:] = (pts[:, 3:] + 1) * 127.5
        scenes.append(dict(name=f"scene{i:04d}_00", points=raw, super_points=sp,
                           instance_mask=inst, boxes=np.asarray(boxes, np.float32),
                           labels=np.arange(4), axis_align_matrix=np.eye(4)))
    path = write_info_dataset(root, scenes, ann_file="port.pkl")
    with open(path, "rb") as f:
        info = pickle.load(f)
    os.remove(path)
    for e in info["data_list"]:
        e["lidar_points"]["lidar_path"] = os.path.basename(e["lidar_points"]["lidar_path"])
        for key in ("pts_semantic_mask_path", "pts_instance_mask_path", "super_pts_path"):
            if key in e:
                e[key] = os.path.basename(e[key])
    os.makedirs(os.path.join(root, "mmdet3d"))
    with open(os.path.join(root, "mmdet3d", "infos_val.pkl"), "wb") as f:
        pickle.dump(info, f)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    import torch

    from unidet3d_tpu_torch.core.class_table import build_class_table
    from unidet3d_tpu_torch.core.config import DATASETS_CLASSES
    from unidet3d_tpu_torch.data.synthetic import reference_state_dict

    base = tmp_path_factory.mktemp("parity")
    root = str(base / "scannet")
    _v2_dataset(root)
    cfg = base / "cfg.py"
    cfg.write_text(CONFIG.format(tiny=TINY, root=root, missing=str(base / "none")))
    ckpt = base / "unidet3d.pth"
    n_cls = len(build_class_table(DATASETS_CLASSES).unified_classes)
    torch.save({"state_dict": reference_state_dict(PLANES, D_MODEL, LAYERS, n_cls)}, ckpt)
    return dict(root=root, cfg=str(cfg), ckpt=str(ckpt))


def test_exit_code_two_without_checkpoint_or_infos(setup, tmp_path, capsys):
    assert parity_eval.main([str(tmp_path / "none.pth"), "--config", setup["cfg"],
                             *FLAGS]) == 2
    assert "checkpoint not found" in capsys.readouterr().err
    assert parity_eval.main([setup["ckpt"], "--config", setup["cfg"], "--datasets",
                             "multiscan", *FLAGS]) == 2
    assert "nothing to evaluate" in capsys.readouterr().err


def test_reanchors_evaluates_and_prints_the_delta_table(setup, capsys, caplog):
    import torch

    from unidet3d_tpu_torch.core.experiment import load_experiment
    from unidet3d_tpu_torch.tools.convert_checkpoint import convert_state_dict
    from unidet3d_tpu_torch.train import loop

    ann = os.path.join(setup["root"], "infos_val.pkl")
    assert not os.path.exists(ann)
    with caplog.at_level("INFO", logger="unidet3d_tpu_torch"):
        code = parity_eval.main([setup["ckpt"], "--config", setup["cfg"], *FLAGS])
    out = capsys.readouterr().out
    assert code == 1  # random weights: far from the released mAP
    assert any("re-anchoring mmdet3d-v2 infos" in m for m in caplog.messages)
    assert any("skipping multiscan" in m for m in caplog.messages)
    with open(ann, "rb") as f:
        converted = pickle.load(f)
    assert [e["lidar_points"]["lidar_path"] for e in converted["data_list"]] == [
        f"points/scene{i:04d}_00.bin" for i in range(3)]

    # The row: the JAX tool's format on evaluate()'s mAP of the converted weights.
    exp = load_experiment(setup["cfg"])
    exp = dataclasses.replace(exp, datasets=exp.datasets[:1])
    net, _ = loop.build_model(exp, device="cpu")
    net.load_state_dict(convert_state_dict(
        torch.load(setup["ckpt"], weights_only=True)["state_dict"], num_levels=len(PLANES),
        num_layers=LAYERS, d_model=D_MODEL))
    res = loop.evaluate(exp, net, device="cpu", logger=lambda *a: None)["scannet"]
    ours = (100 * res["mAP_0.25"], 100 * res["mAP_0.50"])
    ref = parity_eval.REFERENCE_MAP["scannet"]
    header = (f"{'dataset':<12} {'mAP@0.25':>9} {'ref':>6} {'d':>6}  "
              f"{'mAP@0.50':>9} {'ref':>6} {'d':>6}")
    row = (f"{'scannet':<12} {ours[0]:9.1f} {ref[0]:6.1f} {ours[0] - ref[0]:+6.1f}  "
           f"{ours[1]:9.1f} {ref[1]:6.1f} {ours[1] - ref[1]:+6.1f}")
    lines = out.splitlines()
    assert lines[lines.index(header) + 1] == row
    assert "PARITY FAIL (|delta| > 0.3): ['scannet']" in out

    # Within a tolerance above 100 points every delta passes; the infos are
    # now in place, so nothing is re-anchored.
    caplog.clear()
    with caplog.at_level("INFO", logger="unidet3d_tpu_torch"):
        assert parity_eval.main([setup["ckpt"], "--config", setup["cfg"], "--tolerance",
                                 "101", *FLAGS]) == 0
    out = capsys.readouterr().out
    assert row in out.splitlines() and "PARITY OK (all deltas within 101.0)" in out
    assert not any("re-anchoring" in m for m in caplog.messages)


def test_delta_table_marks_datasets_without_a_reference():
    lines, failed = parity_eval.delta_table(
        {"scannet": {"mAP_0.25": 0.771, "mAP_0.50": 0.66}, "other": {"mAP_0.25": 0.5}}, 0.3)
    assert failed == []
    assert lines[1].split() == ["scannet", "77.1", "77.0", "+0.1", "66.0", "65.9", "+0.1"]
    assert lines[2].split() == ["other", "50.0", "--", "--", "0.0", "--", "--"]
