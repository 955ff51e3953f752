"""Import hygiene of the port: it runs without JAX and without the JAX
package, and its entry points use the card unless the caller asks for the
CPU."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, json, pkgutil, sys
import unidet3d_tpu_torch
names = [m.name for m in pkgutil.walk_packages(unidet3d_tpu_torch.__path__,
                                               "unidet3d_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = [m for m in sys.modules
       if m == "jax" or m.startswith(("jax.", "jaxlib", "flax"))
       or m == "unidet3d_tpu" or m.startswith("unidet3d_tpu.")]
print(json.dumps({"imported": names, "bad": bad}))
"""


def test_port_and_chip_smoke_import_no_jax():
    res = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    report = json.loads(res.stdout.strip().splitlines()[-1])
    assert "unidet3d_tpu_torch.models.detector" in report["imported"]
    assert "unidet3d_tpu_torch.tools.probe_conv_bottleneck" in report["imported"]
    for name in ("tools.train", "tools.test", "tools.convert_checkpoint", "train.checkpoint",
                 "train.profiling", "configs.unidet3d_joint", "configs.unidet3d_scannet",
                 "parallel.distributed", "ops.keys", "ops.voxelize", "ops.pyramid",
                 # The visualisation, checkpoint-parity and data-preparation modules.
                 "viz.show_results", "viz.image_vis", "tools.record_activations",
                 "tools.convert_mmdet3d_infos", "tools.parity_eval", "native.segmentator",
                 "native.build", "tools.ply", "tools.create_data", "tools.prep_datasets",
                 "tools.remap_superpoints", "tools.arkitscenes_utils",
                 "tools.arkitscenes_loader"):
        assert f"unidet3d_tpu_torch.{name}" in report["imported"], name
    assert report["bad"] == []


def test_entry_points_need_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from unidet3d_tpu_torch.core.class_table import build_class_table
    from unidet3d_tpu_torch.core.config import DATASETS_CLASSES, default_config
    from unidet3d_tpu_torch.data.batcher import collate, gt_to_device, to_device
    from unidet3d_tpu_torch.data.synthetic import synthetic_scene
    from unidet3d_tpu_torch.models.detector import UniDet3D

    cfg = default_config(max_points=512, voxel_capacity=512, max_superpoints=32,
                         num_planes=(8, 16), num_layers=1, d_model=32,
                         num_heads=1, hidden_dim=32)
    table = build_class_table(DATASETS_CLASSES)
    batch, gt, pack = collate([{"points": synthetic_scene(400, seed=0),
                                "dataset_idx": 0}], cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        UniDet3D(cfg, table)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        to_device(batch, pack)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gt_to_device(gt)
    net = UniDet3D(cfg, table, device="cpu")
    with torch.no_grad():
        out, aux = net(*to_device(batch, pack, "cpu"))
    assert np.isfinite(out.cls_logits.numpy()).all()
