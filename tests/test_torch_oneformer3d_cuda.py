"""OneFormer3D on the card: M1 (``csrc/mask_attention.cu``) against its plain
version at the OneFormer3D ScanNet cell's shapes and at ragged small ones,
bit-equal on a second launch, with its launch count; and the whole forward
at the published widths against the plain fp32 reference, within the
cell's limits (``benchmark/workloads/oneformer3d-scannet-staged-eval.json``,
read as its run reads them: ``benchmark/harness/instseg_oracle.py``), with
37 K1, 6 K3 and 6 M1 launches.

Every test here needs an NVIDIA GPU (Hopper, sm_90a) and nvcc; elsewhere it
skips. Run on the card from the repository root:

    python -m pytest --noconftest -m cuda tests/test_torch_oneformer3d_cuda.py
"""
import json
import math
import os

import pytest
import torch

from unidet3d_tpu_torch.ops import cuda_build
from unidet3d_tpu_torch.ops.attention import attention_tol, flash_attention_cuda
from unidet3d_tpu_torch.ops.mask_attention import (mask_attention_cuda, mask_attention_plain,
                                                   pack_bits)
from unidet3d_tpu_torch.ops.subm_conv_cuda import subm_conv_cuda

pytestmark = pytest.mark.cuda
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "oneformer3d-scannet-staged-eval"


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def m1_inputs(dev, b, lq, lk, density, seed):
    """bf16 q (B, 8, Lq, 32), k, v (B, 8, Lk, 32), bits of the given
    density with a closed row and rows that open a run of keys, and per
    scene lengths a little short of the padded ones."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn((b, 8, n, 32), generator=gen, device=dev).to(torch.bfloat16)
               for n in (lq, lk, lk))
    mask = torch.rand((b, lq, lk), generator=gen, device=dev) < density
    mask[:, 1] = False
    mask[:, 2, lk // 3:lk // 2] = True
    mask[:, 3] = False
    mask[:, 3, lk - 1] = True
    q_len = torch.tensor([lq - 37 * i for i in range(b)], dtype=torch.int32, device=dev)
    k_len = torch.tensor([lk - 29 * i for i in range(b)], dtype=torch.int32, device=dev)
    return q, k, v, pack_bits(mask), q_len.clamp(min=1), k_len.clamp(min=1)


@pytest.mark.parametrize("lq,lk,density", [
    (3092, 3072, 0.5), (3092, 3072, 0.05), (3092, 3072, 1.0), (2068, 2048, 0.3),
    (45, 70, 0.4), (70, 45, 0.4), (64, 64, 0.2), (4, 33, 1.0)])
def test_m1_matches_plain_and_repeats(dev, lq, lk, density):
    if lq == 3092 and density == 0.5:
        reports = cuda_build.build(("mask_attention",))  # fresh build only
        for name, stats in cuda_build.ptxas_report(reports.get("mask_attention", "")):
            print(f"[M1] ptxas {name}: {stats}")
    b = 4 if lq > 100 else 2
    args = m1_inputs(dev, b, lq, lk, density, lq + lk)
    scale = 32 ** -0.5
    before = mask_attention_cuda.launches
    out = mask_attention_cuda(*args, scale)
    again = mask_attention_cuda(*args, scale)
    torch.cuda.synchronize()
    assert mask_attention_cuda.launches == before + 2
    ref = mask_attention_plain(*args, scale)
    torch.testing.assert_close(out.float(), ref.float(), **attention_tol(ref))
    assert torch.equal(out, again)
    q_len = args[4]
    for i in range(b):  # rows past q_len and the closed row are zero
        assert not out[i, :, int(q_len[i]):].any() and not out[i, :, 1].any()


@pytest.mark.parametrize("period", [2, 4, 7])
def test_m1_skips_closed_tiles_and_matches_plain(dev, period):
    """Bits open in 64-key blocks that agree with the 64-row block mod
    `period`: whole tiles closed, which M1 skips, at the cell's shape."""
    q, k, v, _, q_len, k_len = m1_inputs(dev, 4, 3092, 3072, 0.5, period)
    rows = torch.arange(3092, device=dev) // 64 % period
    mask = rows[:, None] == torch.arange(3072, device=dev)[None, :] // 64 % period
    bits = pack_bits(mask[None].expand(4, -1, -1).contiguous())
    out = mask_attention_cuda(q, k, v, bits, q_len, k_len, 32 ** -0.5)
    ref = mask_attention_plain(q, k, v, bits, q_len, k_len, 32 ** -0.5)
    torch.testing.assert_close(out.float(), ref.float(), **attention_tol(ref))
    assert torch.equal(out, mask_attention_cuda(q, k, v, bits, q_len, k_len, 32 ** -0.5))


def test_m1_time_at_the_cells_shape(dev):
    """M1's device ms a launch at the cell's largest group shape (4 scenes,
    3,092 queries, 3,072 superpoints, all valid) at three densities of open
    bits, beside its bound (``benchmark/harness/instseg_counts.py``) and its
    plain version's ms, printed; NVIDIA's events, median of 10 launches."""
    from benchmark.harness.instseg_counts import InstsegShape, mask_attn_bound_s

    scale = 32 ** -0.5
    for density in (0.25, 0.5, 1.0):
        q, k, v, bits, _, _ = m1_inputs(dev, 4, 3092, 3072, density, 7)
        full_q = torch.full((4,), 3092, dtype=torch.int32, device=dev)
        full_k = torch.full((4,), 3072, dtype=torch.int32, device=dev)
        args = (q, k, v, bits, full_q, full_k, scale)
        times = []
        for _ in range(11):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            mask_attention_cuda(*args)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        mask_attention_plain(*args)
        end.record()
        torch.cuda.synchronize()
        shifts = torch.arange(32, device=dev, dtype=torch.int32)
        pairs = int(((bits[..., None] >> shifts) & 1).sum())
        bound = mask_attn_bound_s(InstsegShape((), (3072,) * 4, (pairs,)), 256, 8, 20)
        print(f"[M1] density {density}: {sorted(times[1:])[5]:.4f} ms a launch, bound "
              f"{1e3 * bound:.4f} ms ({pairs} open pairs), plain {start.elapsed_time(end):.2f} ms")


def test_m1_rejects_what_it_does_not_take(dev):
    q, k, v, bits, q_len, k_len = m1_inputs(dev, 2, 64, 64, 0.5, 1)
    with pytest.raises(ValueError):
        mask_attention_cuda(q.float(), k, v, bits, q_len, k_len, 1.0)
    with pytest.raises(ValueError):
        mask_attention_cuda(q, k, v, bits[:, :, :1], q_len, k_len, 1.0)
    with pytest.raises(ValueError):
        mask_attention_cuda(q, k, v, bits, q_len.long(), k_len, 1.0)


def test_forward_at_published_widths_within_the_cells_limits(dev, tmp_path):
    from benchmark.harness import data, instseg_oracle, scenes
    from benchmark.harness.weights import init_from_seed_
    from unidet3d_tpu_torch.configs.oneformer3d_scannet import get_config
    from unidet3d_tpu_torch.data import batcher, pipelines
    from unidet3d_tpu_torch.data.datasets import IndoorDataset
    from unidet3d_tpu_torch.models.oneformer3d import OneFormer3D

    with open(os.path.join(ROOT, "benchmark", "workloads", f"{CELL}.json")) as f:
        wl = json.load(f)
    cfg = get_config().model
    root = scenes.write_dataset(str(tmp_path), scenes.SCANNET, [190000, 61000], 17, data.VAL_ANN)
    ds = IndoorDataset(root, data.VAL_ANN, 0, pipeline=pipelines.test_pipeline("scannet"),
                       test_mode=True)
    samples = [ds[0], ds[1]]
    batch, _, pack = batcher.collate(samples, cfg)
    b, p = batcher.to_device(batch, pack, dev)
    model = init_from_seed_(OneFormer3D(cfg, device=dev), 17)
    launches = (subm_conv_cuda.launches, flash_attention_cuda.launches,
                mask_attention_cuda.launches)
    with torch.no_grad():
        out, aux = model(b, p)
    torch.cuda.synchronize()
    assert (subm_conv_cuda.launches - launches[0], flash_attention_cuda.launches - launches[1],
            mask_attention_cuda.launches - launches[2]) == (37, 6, 6)
    ref = instseg_oracle.reference_model(cfg, 17, dev)
    for i in range(2):
        prog = dict(cls=out.cls_logits[-1, i], masks=out.masks[i], sp_valid=aux.sp_valid[i],
                    bits=[bits[i] for bits in aux.attn_bits])
        sample = instseg_oracle.reference_scene(root, data.VAL_ANN, i)
        read = instseg_oracle.scene_gaps(ref, sample, cfg, cfg.max_superpoints, prog,
                                         float(wl["band"]), dev)
        print(f"[of3d-forward] scene {i}: " + ", ".join(
            f"{k} {read[k]!r}" for k in ("input_mismatch", "fwd_logits_gap", "fwd_mask_gap",
                                         "mask_flips")))
        for key in ("input_mismatch", "fwd_logits_gap", "fwd_mask_gap", "mask_flips"):
            assert math.isfinite(read[key]) and read[key] <= wl["limits"][key], (key, read[key])


def test_test_cli_on_the_cells_scenes(dev, tmp_path, caplog):
    """tools/test.py through evaluate on the cell's 16 scenes written to
    disk (seed 17), weights from the seed in a checkpoint: the numbers
    (meaningless with random weights) and the scenes/s of evaluate's
    eval_stats, printed."""
    import logging

    from benchmark.harness import data
    from benchmark.harness.weights import init_from_seed_
    from unidet3d_tpu_torch.tools import test as test_cli
    from unidet3d_tpu_torch.train import loop
    from unidet3d_tpu_torch.train.checkpoint import CheckpointManager

    with open(os.path.join(ROOT, "benchmark", "workloads", f"{CELL}.json")) as f:
        wl = json.load(f)
    root = data.write(str(tmp_path), wl["raw_points"], wl["files"], 17, data.VAL_ANN)["scannet"]
    cfg_file = tmp_path / "of3d_cell.py"
    cfg_file.write_text(
        "import dataclasses\n"
        "from unidet3d_tpu_torch.configs.oneformer3d_scannet import get_config as base\n"
        "from unidet3d_tpu_torch.core.experiment import DatasetSpec\n"
        "def get_config():\n"
        "    return dataclasses.replace(base(), datasets=(DatasetSpec(name='scannet', "
        f"data_root={root!r}, ann_val={data.VAL_ANN!r}),), eval_batch_size=4, "
        f"work_dir={str(tmp_path)!r})\n")
    from unidet3d_tpu_torch.core.experiment import load_experiment

    exp = load_experiment(str(cfg_file))
    model, _ = loop.build_model(exp, dev)
    init_from_seed_(model, 17)
    CheckpointManager(str(tmp_path / "checkpoints")).save(
        1, model, torch.optim.SGD(model.parameters(), lr=0.0))
    with caplog.at_level(logging.INFO, logger="unidet3d_tpu_torch"):
        res = test_cli.main([str(cfg_file), str(tmp_path / "checkpoints")])
    stats = [r.eval_stats for r in caplog.records if hasattr(r, "eval_stats")]
    numbers = res["scannet"]
    print(f"[of3d-test-cli] AP {numbers['AP']!r} AP50 {numbers['AP50']!r} "
          f"AP25 {numbers['AP25']!r} mIoU {numbers['mIoU']!r}; "
          f"{stats[0]['scenes']} scenes in {stats[0]['seconds']:.3f} s "
          f"({stats[0]['scenes'] / stats[0]['seconds']:.3f} scenes/s, loader start included)")
    assert stats[0]["scenes"] == wl["files"]["scannet"] and math.isfinite(numbers["mIoU"])
