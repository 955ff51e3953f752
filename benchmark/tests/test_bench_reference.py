"""The frozen reference agrees with the port's CPU path at a tiny size: with
the program in fp32, every number of the comparison reads zero (the same
batches, losses, gradients, steps, forwards and detections, bit for bit);
and the harness's scene writer and weights are the seed's alone."""
import numpy as np
import pytest
import torch

import tiny
from benchmark.harness import scenes
from benchmark.harness.weights import init_from_seed_


@pytest.mark.parametrize("name", ["joint-train-staged", "scannet-train-loader", "joint-eval"])
def test_reference_equals_the_program_in_fp32(name):
    line = tiny.run(name, seed=2**31 + 11, compute_dtype="float32")
    readings = {k: c["value"] for k, c in line["checks"].items()}
    assert all(v == 0 for v in readings.values()), readings
    assert line["correct"] is True


def test_same_seed_same_scene_and_weights():
    seed = scenes.scene_seed(2**33 + 1, 0, 0)  # a run's seed may pass 32 bits
    a = scenes.info_scene(0, "a", 4000, seed)
    b = scenes.info_scene(0, "a", 4000, seed)
    assert all(np.array_equal(a[k], b[k]) for k in ("points", "super_points", "boxes"))
    from benchmark.reference.refnet.core.class_table import build_class_table
    from benchmark.reference.refnet.core.config import DATASETS_CLASSES, default_config
    from benchmark.reference.refnet.models.detector import UniDet3D
    from unidet3d_tpu_torch.core.class_table import build_class_table as port_table
    from unidet3d_tpu_torch.models.detector import UniDet3D as PortDet

    cfg = default_config(**{k: v for k, v in tiny.MODEL.items()})
    ref = init_from_seed_(UniDet3D(cfg, build_class_table(DATASETS_CLASSES), device="cpu"), 9)
    port = init_from_seed_(PortDet(cfg, port_table(DATASETS_CLASSES), device="cpu"), 9)
    pairs = list(zip(ref.named_parameters(), port.named_parameters()))
    assert len(pairs) > 10
    for (n1, p1), (n2, p2) in pairs:
        assert n1 == n2 and torch.equal(p1, p2)
