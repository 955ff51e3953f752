"""The OneFormer3D cell at a tiny size on the CPU (fp32, the plain versions
of the kernels): a sound run reads correct with every number at zero but
the forward's gaps, a traced run carries the cell's per-layer metrics, a
fault planted in the post-processing or the metric comes out not correct,
and the correctness control reads further off than the program.

    python -m pytest benchmark/tests/test_bench_instseg.py -q"""
import copy
import tempfile
import time

import pytest
import torch

from benchmark.harness import instseg_control, registry, runner

NAME = "oneformer3d-scannet-staged-eval"
MODEL = dict(num_planes=(8, 16), d_model=32, num_heads=1, hidden_dim=32, num_layers=2,
             max_points=8192, voxel_capacity=16384, max_superpoints=256, max_gts=16,
             compute_dtype="float32")


def workload() -> dict:
    wl = copy.deepcopy(registry.workload(NAME))
    wl["raw_points"] = {"scannet": [3000, 6000]}
    wl["files"] = {"scannet": 8}
    return wl


def context(scratch, seed=5, trace=False):
    return runner.Context(workload=workload(), config=registry.config("oneformer3d_scannet"),
                          seed=seed, seconds=1.0, trace=trace, device=torch.device("cpu"),
                          t_start=time.perf_counter(), scratch=scratch, model_overrides=MODEL)


def run(trace=False) -> dict:
    torch.set_num_threads(2)
    with tempfile.TemporaryDirectory() as d:
        return runner.execute(context(d, trace=trace), registry.driver("eval_staged"))


def test_a_sound_run_is_correct_and_traced_metrics_are_read():
    line = run(trace=True)
    checks = {k: c["value"] for k, c in line["checks"].items()}
    assert line["correct"] is True, checks
    for key in ("input_mismatch", "mask_flips", "post_mismatch", "ap_gap", "planted_ap_gap",
                "drops", "launch_mismatch"):
        assert checks[key] == 0, key
    assert checks["fwd_logits_gap"] < 1e-4 and checks["fwd_mask_gap"] < 1e-4
    # On the CPU no device time: the device trace's metrics are left out.
    assert set(line["metrics"]) == {"instseg_post_ms.instseg", "instseg_forward_mfu.instseg"}


def test_an_altered_semantic_map_is_caught(monkeypatch):
    from unidet3d_tpu_torch.train import loop

    original = loop.predict_instances

    def altered(*args, **kw):
        pred = original(*args, **kw)
        return pred._replace(semantic=(pred.semantic + 1) % 20)

    monkeypatch.setattr(loop, "predict_instances", altered)
    line = run()
    assert line["correct"] is False
    assert line["checks"]["post_mismatch"]["value"] > 0


def test_a_metric_that_miscounts_the_semantic_map_is_caught(monkeypatch):
    from unidet3d_tpu_torch.train import instance_metric

    original = instance_metric.InstanceSegMetric.process

    def shifted(self, *args):
        *rest, sem_conf = args
        return original(self, *rest, sem_conf[[*range(1, 20), 0, 20]])

    monkeypatch.setattr(instance_metric.InstanceSegMetric, "process", shifted)
    line = run()
    assert line["correct"] is False
    assert line["checks"]["ap_gap"]["value"] > 0


def test_a_metric_without_the_size_floor_is_caught(monkeypatch):
    """With random weights no instance of the model's matches the ground
    truth and ap_gap reads 0 either way; the planted instances do match."""
    from unidet3d_tpu_torch.train import instance_metric

    monkeypatch.setattr(instance_metric, "MIN_REGION", 0)
    line = run()
    assert line["correct"] is False
    assert line["checks"]["planted_ap_gap"]["value"] > 0


def test_planted_predictions_give_the_metric_work():
    from benchmark.drivers.eval_staged import stage_groups
    from benchmark.harness import data, instseg_oracle, training
    from unidet3d_tpu_torch.train import loop
    from unidet3d_tpu_torch.train.instance_metric import InstanceSegMetric, count_group

    with tempfile.TemporaryDirectory() as d:
        ctx = context(d)
        exp, cfg = training.model_config(ctx)
        root = data.write(d, ctx.workload["raw_points"], ctx.workload["files"], ctx.seed,
                          data.VAL_ANN)["scannet"]
        groups = stage_groups(ctx, exp, cfg, root)
        metric = InstanceSegMetric()
        for group in groups:
            pred = instseg_oracle.planted_predictions(group, ctx.seed, ctx.device)
            loop.drain(metric, (count_group(pred, group.samples), group))
        res = metric.compute(logger=None)["scannet"]
        assert 0 < res["AP"] < res["AP50"] <= res["AP25"] < 1 and 0 < res["mIoU"] < 1
        assert instseg_oracle.planted_ap_gap(groups, root, data.VAL_ANN, ctx.seed,
                                             ctx.device) == 0


def test_the_control_reads_further_off_than_the_program(tmp_path):
    ctx = context(str(tmp_path))
    read = instseg_control.readings(ctx)
    mine = {k: c["value"] for k, c in run()["checks"].items()}
    low = read["control"]
    assert low["fwd_logits_gap"] > mine["fwd_logits_gap"]
    assert low["fwd_mask_gap"] > mine["fwd_mask_gap"]
    # The planted fault (attention left unmasked) shows only where the
    # masks leave some keys closed: at the published widths on the chip, not
    # at this width, where every row of every set is closed whole and so
    # reopened. Here it reads what a sound program reads.
    assert read["no_mask"]["fwd_logits_gap"] == 0 and read["no_mask"]["mask_flips"] == 0
    assert read["no_floor"]["planted_ap_gap"] > 0


def test_conv_and_attention_rooflines_read_the_cells_forwards():
    """The existing family readers read the cell's traced forwards: the
    backbone's levels, and K3's rows (the semantic queries and the valid
    superpoints of each scene) over its padded length."""
    from benchmark.drivers.eval_staged import family_shapes
    from benchmark.harness import counts, readers

    shape = dict(capacity=[4096, 1024], n_valid=[3000, 700], pairs=[40000, 9000],
                 superpoints=torch.tensor([100, 60]), open_pairs=torch.tensor([5000, 6000]),
                 slots=128)
    (family,) = family_shapes([shape], 20)
    assert family == (counts.BatchShape(
        (counts.LevelShape(4096, 3000, 40000), counts.LevelShape(1024, 700, 9000)),
        (120, 80)), 148)
    dims = dict(planes=(8, 16), d_model=32, num_heads=1, hidden=32, num_layers=2, n_sem=20,
                n_classes=18)
    conv = counts.conv_bound_s(family[0], dims["planes"], False)
    attn = counts.attn_bound_s(family[0], 148, 1, 2, False)
    record = dict(traced_shapes=[family], train=False, dims=dims, trace=dict(kernel_s={
        "void subm_conv_mma_kernel<8, 0>(...)": 4 * conv,
        "void flash_fwd_mma_kernel<true>(...)": 2 * attn,
        "mask_attention_mma_kernel(...)": 1.0}))
    assert readers.roofline(record, "conv") == pytest.approx(25.0)
    assert readers.roofline(record, "attn") == pytest.approx(50.0)
