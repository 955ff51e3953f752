"""Chip smoke test of the PyTorch/CUDA port (``unidet3d_tpu_torch``) on one
NVIDIA GPU. Run from the repository root on a machine with the card and nvcc:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. build the Hopper kernels (subm conv forward K1, templated on the modes
     of the conv-bottleneck probe P1, and weight gradient K2, flash attention
     forward K3 and backward K3-dkv / K3-dq) with nvcc, one process per
     source, all at once; the bf16 routes of K1 (and K1'), K2, K3, K3-dkv
     and K3-dq run on the tensor cores (mma.sync), the fp32 routes on FMAs;
  2. P1, the conv-bottleneck probe, through its tool
     (`unidet3d_tpu_torch/tools/probe_conv_bottleneck.py`): one call of each
     of its four modes (full, gather_only, no_gather, no_table) with the
     launches counted, each mode against its plain version (rtol = atol =
     1e-3) and full against K1 bit for bit, at the probe's shape (one
     131,072-point scene, seed 5, level 0, 32 -> 32, bf16), then the
     bisection: each mode's time per probe call beside its bound, its plain
     version's and its library call's, and the gaps between the modes;
  3. K1, the submanifold conv, against its plain PyTorch version at every
     distinct (level, Cin, Cout) shape of the 37 convs of one forward, on the
     neighbor tables of 4 synthetic 131k-point scenes (the production eval
     group), bf16 inputs, bit-equal on a second launch, with the bf16
     kernel's registers, spills and shared memory per column width;
  4. K3, the segment-masked flash attention, against its plain version at
     B=4, H=8, Q=3072, head dim 32, bf16, with and without the logsumexp
     (the same o), bit-equal on a second launch, with its registers, spills
     and shared memory;
  4a. [sp-trim]: the superpoint trimming kernel (csrc/sp_trim.cu) against
     its plain version, trim_boxes_by_superpoints, bit for bit at the eval
     path's shapes (data/synthetic.py::trim_group: 4 scenes of 196,608
     slots with 52k-190k valid, K 1000, S 3072, superpoints of 64 points,
     fractions at both thresholds), bit-equal on a second launch, its ms
     per group of 4 (one launch for the group, as predict_batch makes it)
     beside its bound and the plain version's, and its registers, spills
     and shared memory;
  4b. [pool]: G1, the point-to-superpoint pooling (csrc/point_pool.cu),
     forward and backward equal to the plain path on the CPU (gather,
     segment mean, autograd's backward) bit for bit, twice, at the staged
     training cell's shapes (data/synthetic.py::pool_batch: 8 x 196,608
     slots, 885,000 valid), each direction's ms beside its bound, the plain
     path's and index_select / index_add_'s; phases 6 and 13 assert its
     calls on the main paths (one a forward, one a backward);
  5. the whole eval forward on the card (through K1 and K3) against the same
     forward on the CPU (plain versions), fp32, one 16k-point scene;
  6. the production eval path at full width, bf16: collate (native
     rulebooks) -> to_device ->
     forward -> predict_batch on the 4 scenes, with the kernel launches of
     one run counted (37 K1 and 6 K3 per forward, no probe, one trimming
     launch per group) and the warm
     group time, then one group under torch.profiler (device time by kernel,
     idle share);
  7. [prod-rot]: phase 6 on 4 synthetic ARKitScenes scenes (dataset 5,
     rotated NMS, no superpoint trimming), with the card time of
     pairwise_iou_rotated per group, and it under the profiler;
  8. [map]: the decoder outputs of the groups of phases 6 and 7 through
     predict_batch on the card and, moved over, on the CPU: equal keep masks
     outside order swaps of near-equal scores and same-class IoUs within 1e-4
     of iou_thr, and the same mAP@0.25 / 0.50 from IndoorMetric (random
     weights: the values say nothing about accuracy);
  9. K1, K1' (the conv input gradient: K1 on the mirrored weights) and K2
     (the conv weight gradient) against their plain versions at every
     distinct (level, Cin, Cout) of the training step, on the neighbor
     tables of the 8-scene training batch, bf16, each bit-equal on a second
     launch (phase 3's code), with K2's block shape (wgrad_tile) per shape,
     each shape where a kernel is slower than its index_select + mm
     yardstick marked, and K2's registers, spills and shared memory per
     instance;
 10. K3 with its logsumexp, and K3-dkv / K3-dq against the plain backward, at
     B=8, H=8, L=3072, head dim 32, in bf16 and in fp32 (phase 4's code);
     the bf16 kernels' and SDPA's backward against the fp32 plain backward
     (each kernel within twice SDPA's error), and the backward kernels'
     registers, spills and shared memory from ptxas;
 11. one fp32 training step on the card against the same step on the CPU,
     at full width on two small scenes: loss and every gradient, with the
     card's run-to-run noise read first and the held step run in PyTorch's
     deterministic mode;
 12. [train-rot-small]: phase 11 with a MultiScan and an ARKitScenes scene
     (one deterministic card step against the CPU, the same bounds), then
     the criterion alone under torch.cuda.set_sync_debug_mode("error");
 13. the production training step at full width, bf16: 8 synthetic
     131k-point scenes (4 with ScanNet's flags, 4 with MultiScan's) with
     ground truth, 6 steps of make_train_step on the same collated batch,
     the kernel launches of every step counted (K1 37, K1' 36, K2 37, K3 6,
     K3-dkv 6, K3-dq 6, no probe), a falling loss, the warm step split into
     H2D, forward + loss, backward and optimizer, then one step under
     torch.profiler;
 14. [train-rot]: phase 13 on 3 ScanNet, 3 MultiScan and 2 ARKitScenes
     scenes (GT boxes with yaw) for 4 steps, with the card time of the
     rotated matcher costs of one step, and them under the profiler;
 15. [native-pack]: the native rulebook builder (native/rulebook.cc, built
     by g++) against the numpy builder on the eval group of phase 6 and the
     training batch of phase 13: every table, row and n_valid equal, and
     each builder's seconds (native on one thread and on every core);
 16. [loader-train]: on-disk datasets in the reference's info format (8
     ScanNet scenes with raw nyu40 semantic ids, 4 MultiScan, 4 ARKitScenes
     with yawed boxes; 131,072 points each, written to a temporary
     directory and removed at the end) -> TrainLoader over their
     ConcatDataset with augmentation on (elastic distortion for ScanNet),
     batch 8 at the full config, the batches staged on the card by the
     loader's workers (pinned buffers, a side stream) -> 8 steps of
     make_train_step: launches of every step (37/36/37/6/6/6), finite
     losses, step time with the wait excluded, the consumer's wait in
     next(loader), the sustained scenes/s over steps 3-8 with the waits,
     the workers' seconds per batch (pipeline, collate, pack, staging), and
     one staged batch bit-equal to a synchronous to_device of its arrays;
     the same 8 batches again with 2 and 8 workers, and once more with no
     loader running (synchronous to_device in each step);
 17. [eval-loop]: evaluate() at the full config over on-disk validation sets
     (12 ScanNet scenes of 48k-131k points, 8 ARKitScenes scenes through
     the test pipeline's 100k-point cap), groups of 4, random weights:
     scenes/s, ms per group, the loop's wait per group and the buckets per
     dataset, 37 K1 and 6 K3 launches per group's forward, the mAP dict,
     and the oracle (each scene's ground truth as its detections: AP 1.0
     for every class with ground truth);
 18. [eval-loop-small]: evaluate() at a small fp32 config on 4 small 3RScan
     scenes on the card and on the CPU from the same weights: keep masks
     (as [map]), equal mAP dicts, the oracle;
 19. [train-cli]: tools.train.main in this process (the user's entry
     point: train() over TrainLoader, checkpoints, validation) with a config
     file the phase writes: the full config, batch 8, 2 epochs x 4 steps on
     phase 16's on-disk training sets, a log line every 2 steps, a
     checkpoint every epoch keeping 1, validation after epoch 2 on phase
     17's validation sets: launches per step (37/36/37/6/6/6 once the
     validation's forwards are taken out), finite losses, the loop's
     sustained scenes/s over steps 3-8 beside phase 16's, seconds and bytes
     per checkpoint save (model and AdamW moments copied off the card), the
     validation's seconds;
 20. [test-cli]: tools.test.main on that checkpoint: the validation's
     datasets, scenes, groups and buckets, and its mAP within MAP_BOUND of
     the in-loop validation's on every result key;
 21. [resume]: the kept checkpoint equal bit for bit to the model and
     optimizer train() returned, and restored into a fresh pair bit for bit
     (count 8, the next lr the schedule's at 8); then tools.train.main
     --resume auto with epochs 3: it starts at step 8 and trains epoch 3
     (launches per step, the lr at step 10);
 22. [load-from]: a synthetic reference-format unidet3d.pth at the
     production widths through tools.convert_checkpoint.main, then
     tools.train.main with load_from and no epochs: every backbone.* tensor
     equal to the converted one, every decoder.* tensor to the seeded init;
 23. [device-pack]: build_gridpack_device (the detector's fallback when
     it is handed no pack) on phase 6's group staged on the card: every
     table, row and n_valid equal to the native builder's, the builder's
     ms beside phase 15's seconds, and, in deterministic mode, the forward
     without a pack (37 K1, 6 K3) equal bit for bit to the native-pack
     forward (run after phase 15);
 24. [ddp]: data parallelism over torch.distributed, 2 ranks spawned on the
     one card over gloo, 4 of phase 13's 8 scenes each: launches per rank
     per step, the deterministic step against the one-process step on the
     8 scenes within 3x the card's run-to-run noise (loss, every gradient,
     the running statistics), parameters bit-equal across ranks after 2
     steps, step ms, the gradient all-reduce's ms and each rank's peak
     memory; then tools.train.main in both ranks (1 epoch x 2 steps,
     validation on phase 17's sets): one checkpoint written by rank 0,
     equal models, equal gathered metric dicts (run after phase 28);
 25. [show-dir]: evaluate() with show_dir on the card over phase 17's
     validation sets: one directory per real scene named by its index in
     its info file, none twice, each _pred.obj with as many boxes as the
     card's keep mask of its scene, 37 K1 and 6 K3 per forward; then
     evaluate() on the CPU over the same scenes (a narrow model): every
     _points.obj and _gt.obj equal byte for byte (run after phase 22);
 26. [record-activations]: tools.record_activations.main on the card
     (seeded_init_(0), the 4,096-point fixture scene): the probe names,
     shapes and dtypes of tests/fixtures/activations_seed0.npz, 37 K1 and 6
     K3 launches, and in fp32 each probe within phase 5's bound of the same
     recorder on the CPU over valid rows;
 27. [parity-eval]: tools.parity_eval.main on phase 22's synthetic
     reference unidet3d.pth over ScanNet scenes whose infos exist only in
     mmdet3d-v2 form (the re-anchor path): the delta table, exit 1 at the
     default tolerance (random weights) and 0 at a tolerance above 100;
 28. [prep]: the native segmentator built with g++ and run on a
     100,489-vertex mesh, two scenes exported through create_data's generic
     path and one through prepare_multiscan, read back through
     IndoorDataset, and one evaluate() group of each on the card; the
     build's seconds, the segmentator's seconds per 100k vertices and the
     export's seconds per scene;
 29. [overfit-small]: training that learns (tests/test_torch_overfit.py on
     the card): its 4 coherent scenes (data/synthetic.py::
     write_coherent_dataset, the JAX test's data byte for byte) and small
     config with one attention head (the kernels' head dim 32), bf16: the
     kernels at these narrow shapes against their plain versions, then
     train() for 100 one-step epochs of batch 8 at lr 3e-3 and evaluate():
     the launches of every step (13/12/13/2/2/2 for 2 levels and 2
     layers), the loss falling under a fifth, mAP@0.25 > 0.9 and mAR@0.25
     == 1.0 (the JAX test's bars; run after phase 24);
 30. [overfit]: the same bars at the production widths, bf16, through
     tools.train.main with a config file the phase writes, on 4 coherent
     scenes of 20,000 points (capacities, query_thr and topk_insts for that
     size), batch 8, 250 steps at lr 3e-4, validation every 10 steps, then
     evaluate() on the same scenes: launches per step (37/36/37/6/6/6), the
     loss at each log interval, the steps and seconds until a validation
     first met the bars, s per step, the mAP dict, peak memory;
 31. [prod-ref]: the production eval path (collate, to_device, forward,
     predict_batch) on reference-scale scenes (ScanNet scans of 52k-190k
     points, tests/test_torch_reference_scale_budgets.py's mix) at the
     default config in groups of 4: zero drops, every point valid, 37 K1
     and 6 K3 per forward, ms per group, peak memory;
 32. [m1]: M1, OneFormer3D's masked cross-attention (csrc/mask_attention.cu),
     against its plain version (attention_tol, which the plain version with
     every bit open fails) at the OneFormer3D ScanNet cell's shape (4 scenes,
     8 heads, 3,092 queries, 3,072 keys, head dim 32, bf16) at 25, 50 and 100
     % of random open bits and at 25 % in 64-key blocks (where its tile
     skipping works), bit-equal on a second launch, its time beside its
     bound, its plain version's and SDPA's with a boolean mask; then the main
     path, OneFormer3D at its published widths (configs/oneformer3d_scannet)
     on the 4 largest of [prod-ref]'s scenes: forward and predict_instances
     with the counters reset just before, 37 K1, 6 K3 and 6 M1 launches, and
     M1, its plain version and SDPA timed on the 6 launches' own inputs;
 33. the whole script's wall time, the `kernels` JSON line (per training
     step of phase 13; the probe's modes per probe call; M1 per forward of
     [m1]'s main path), the card's name and power limit, and the final JSON
     line.
Times are CUDA-event means (the conv kernels per shape: the median of 5 such
means) or synchronised host-clock medians on the card in this run.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import io
import json
import logging
import os
import pickle
import socket
import statistics
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from unidet3d_tpu_torch.core.class_table import build_class_table
from unidet3d_tpu_torch.core.config import DATASETS_CLASSES, default_config
from unidet3d_tpu_torch.core.experiment import (
    DatasetSpec,
    ExperimentConfig,
    apply_overrides,
    load_experiment,
)
from unidet3d_tpu_torch.data.batcher import (
    build_packs,
    collate,
    gt_to_device,
    map_arrays,
    to_device,
)
from unidet3d_tpu_torch.data.dataset_specs import DEFAULT_LABEL_MAPPINGS, SCANNET_DET_CAT_IDS
from unidet3d_tpu_torch.data.datasets import ConcatDataset, IndoorDataset
from unidet3d_tpu_torch.data.loader import TrainLoader
from unidet3d_tpu_torch.data.synthetic import (
    POOL_VALID,
    REFERENCE_SCALE_POINTS,
    TRIM_VALID,
    pool_batch,
    reference_scale_scenes,
    reference_state_dict,
    stripe_superpoints,
    synthetic_scene,
    trim_group,
    write_coherent_dataset,
    write_info_dataset,
)
from unidet3d_tpu_torch.data.telemetry import DROPS
from unidet3d_tpu_torch.device import card_line, cuda_ms, sm_clock_hz
from unidet3d_tpu_torch.losses.criterion import criterion, match_scene, rotated_costs
from unidet3d_tpu_torch.models.detector import (
    UniDet3D,
    detection_loss,
    prepare_gt,
    rotated_scenes_of,
    scene_flags,
)
from unidet3d_tpu_torch.models.decoder import NEG_INF
from unidet3d_tpu_torch.models.postprocess import (
    predict_batch,
    select_topk_instances,
    trim_boxes_by_superpoints,
)
from unidet3d_tpu_torch.native import segmentator
from unidet3d_tpu_torch.ops import cuda_build
from unidet3d_tpu_torch.ops.attention import (
    attention_bwd_plain,
    attention_plain,
    attention_tol,
    flash_attention_cuda,
    flash_attention_dkv_cuda,
    flash_attention_dq_cuda,
)
from unidet3d_tpu_torch.ops.mask_attention import (
    mask_attention_cuda,
    mask_attention_plain,
    pack_bits,
    unpack_bits,
)
from unidet3d_tpu_torch.ops.gridpack import (
    build_gridpack_device,
    build_gridpack_host,
    build_gridpack_numpy,
    quantize_points_device,
)
from unidet3d_tpu_torch.ops.nms import pairwise_iou_aa, pairwise_iou_rotated
from unidet3d_tpu_torch.ops.point_pool_cuda import (
    point_pool_bwd_cuda,
    point_pool_cuda,
    point_pool_plain,
)
from unidet3d_tpu_torch.ops.probe_conv import MODES as PROBE_MODES
from unidet3d_tpu_torch.ops.probe_conv import probe_conv_cuda
from unidet3d_tpu_torch.ops.sp_trim_cuda import sp_trim_cuda
from unidet3d_tpu_torch.ops.sparse_conv import subm_conv, subm_conv_dgrad, subm_conv_wgrad
from unidet3d_tpu_torch.ops.subm_conv_cuda import (
    conv_tile,
    subm_conv_cuda,
    subm_conv_dgrad_cuda,
    subm_conv_wgrad_cuda,
    wgrad_smem,
    wgrad_tile,
)
from unidet3d_tpu_torch.parallel.distributed import (
    average_gradients,
    broadcast_module,
    destroy,
    maybe_initialize,
)
from unidet3d_tpu_torch.parallel.train_step import make_train_step
from unidet3d_tpu_torch.tools import convert_checkpoint, create_data, parity_eval, prep_datasets
from unidet3d_tpu_torch.tools import record_activations as record_tool
from unidet3d_tpu_torch.tools import test as test_cli
from unidet3d_tpu_torch.tools import train as train_cli
from unidet3d_tpu_torch.tools.probe_conv_bottleneck import measure, probe_inputs, run_modes
from unidet3d_tpu_torch.train.checkpoint import CheckpointManager
from unidet3d_tpu_torch.train.loop import build_datasets, build_model, evaluate, train
from unidet3d_tpu_torch.train.metric import IndoorMetric
from unidet3d_tpu_torch.train.optim import make_optimizer
from unidet3d_tpu_torch.weights import seeded_init_

# H100 SXM published peaks (NVIDIA data sheet): HBM rate and dense bf16 rate.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
SCENE_POINTS = 131072
GROUP = 4  # the production eval group size
TRAIN_BATCH = 8  # the joint training config's batch size
TRAIN_STEPS = 6
SP_SIZE = 45  # points per superpoint stripe: ~1 superpoint per 45 points
SP_PER_GT = 20  # ground-truth instances: runs of 20 consecutive stripes
N_GTS = 64  # instances per training scene
ARKIT = 5  # ARKitScenes, the rotated dataset of the joint mixture
# The rotated training batch: 3 ScanNet, 3 MultiScan and 2 ARKitScenes scenes.
ROT_TRAIN_DATASETS = (0, 0, 0, 2, 2, 2, ARKIT, ARKIT)
ROT_TRAIN_STEPS = 4
# The kernels, in the order of the `kernels` line.
COUNTERS = {
    "subm_conv": subm_conv_cuda,
    "subm_conv_dgrad": subm_conv_dgrad_cuda,
    "subm_conv_wgrad": subm_conv_wgrad_cuda,
    "flash_attention": flash_attention_cuda,
    "flash_attention_dkv": flash_attention_dkv_cuda,
    "flash_attention_dq": flash_attention_dq_cuda,
}
# The probe's modes, by their names in the `kernels` line; one wrapper counts
# the launches of each mode.
PROBES = {f"probe_conv_{mode}": mode for mode in PROBE_MODES}
NO_LAUNCHES = dict.fromkeys([*COUNTERS, *PROBES], 0)
TRAIN_LAUNCHES = dict(NO_LAUNCHES, subm_conv=37, subm_conv_dgrad=36, subm_conv_wgrad=37,
                      flash_attention=6, flash_attention_dkv=6, flash_attention_dq=6)
# exp2 results per clock per SM of the special-function units (sm_90).
SFU_EXP_PER_CLOCK = 16
# fp32 lanes per SM (sm_90), and the fp32 operations superpoint trimming
# needs per (valid point, box) pair at yaw 0, the inside test: 3
# subtractions for the shift, 6 additions for the face distances and 6
# comparisons (the count and the min / max are taken by the inside pairs
# alone, a few in a hundred).
FP32_LANES = 128
TRIM_OPS_PER_PAIR = 15
# The fp32 card training step against the CPU's, per gradient tensor. Runs
# of the card step with PyTorch's default algorithms (atomic sums) differ from
# each other in the backbone's gradients about 300x more, relative to the
# tensor, than in the rest's (decoder, heads: reached first by the backward),
# as much as the card differs from the CPU. Phase 9 prints that noise over
# NOISE_STEPS runs in every run (PERF.md keeps the readings); each bound is
# about 3x it.
NOISE_STEPS = 6
BACKBONE_RTOL = 2e-2  # |a - b| <= BACKBONE_RTOL |b| + 1e-8, in norm
HEAD_RTOL = 1e-4  # max|a - b| <= HEAD_RTOL max|b| + 1e-8


def reset_counts():
    for fn in COUNTERS.values():
        fn.launches = 0
    probe_conv_cuda.launches = dict.fromkeys(PROBE_MODES, 0)


def read_counts() -> dict:
    counts = {name: fn.launches for name, fn in COUNTERS.items()}
    counts.update({name: probe_conv_cuda.launches[mode] for name, mode in PROBES.items()})
    return counts


def pool_calls() -> tuple:
    """G1's (forward, backward) calls so far."""
    return point_pool_cuda.launches, point_pool_bwd_cuda.launches


def make_scenes(n_scenes, n_points, seed0=0):
    samples = []
    for i in range(n_scenes):
        pts = synthetic_scene(n_points, seed=seed0 + i)
        samples.append({"points": pts, "dataset_idx": 0,
                        "sp_pts_mask": stripe_superpoints(pts, SP_SIZE)})
    return samples


def conv_shapes(planes):
    """{(level, cin, cout): calls per forward} of the 37 submanifold convs."""
    shapes = {(0, 6, planes[0]): 1}  # input conv
    for lvl, c in enumerate(planes):
        shapes[(lvl, c, c)] = shapes.get((lvl, c, c), 0) + 4  # 2 pre-blocks
        if lvl < len(planes) - 1:
            shapes[(lvl, 2 * c, c)] = 1  # first tail block, conv1
            shapes[(lvl, c, c)] += 3  # its conv2 + the second tail block
    return shapes


def ptxas_line(name, stats) -> str:
    return (f"{name} {stats.get('registers')} registers, spill stores "
            f"{stats.get('spill_stores')} B, spill loads {stats.get('spill_loads')} B, "
            f"smem {stats.get('smem', 0)} B")


def phase_build():
    """Builds every kernel; returns {source: ptxas_report} of those built."""
    t0 = time.time()
    reports = {name: cuda_build.ptxas_report(log)
               for name, log in cuda_build.build().items()}
    secs = time.time() - t0
    for name, kernels in reports.items():
        print(f"[build] {name}: " + "; ".join(ptxas_line(*kern) for kern in kernels))
    print(f"[build] nvcc for {list(reports) or 'nothing (cached)'}: {secs:.1f} s")
    return reports


def phase_probe(card):
    """P1 through its tool's functions: one call of each mode on the
    probe's inputs with the launches counted from zero (the probe's own
    path), then each mode held against its plain version and full against
    K1's bits, and the bisection timed. Returns {kernels-line name: numbers
    per probe call, with that run's launches}."""
    inputs = probe_inputs(device="cuda")
    reset_counts()
    outs = run_modes(inputs)
    torch.cuda.synchronize()
    launches = read_counts()
    assert launches == dict(NO_LAUNCHES, **dict.fromkeys(PROBES, 1)), launches
    res = measure(inputs, outs, card)
    return {name: dict(res[mode], launches=launches[name]) for name, mode in PROBES.items()}


def phase_conv(pack_np, planes, card, backward, ptxas=(), tag=None):
    """K1 -- and with `backward` also K1' and K2 -- against their plain
    versions at each distinct (level, Cin, Cout) of the submanifold convs of
    `planes` (37 at 5 levels), on this pack's neighbor tables, with bf16
    features, weights and
    cotangents, each bit-equal on a second launch; prints the bf16 conv
    kernels' registers, spills and shared memory per instance (`ptxas`: the
    conv sources' ptxas_report entries), and marks each kernel slower than
    its index_select + mm yardstick at a shape. Returns the totals per
    kernel over one forward (one training step with `backward`)."""
    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    names = ("subm_conv", "subm_conv_dgrad", "subm_conv_wgrad")[: 3 if backward else 1]
    tag = tag or ("conv-train" if backward else "K1")
    tot = {k: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                   bytes_ms=0.0, ops_ms=0.0, max_abs_err=0.0) for k in names}
    for name, stats in ptxas:  # K1 (mode 0, per width) and K2 instances
        args = name.split("<")[-1].rstrip(">").split(", ")
        if name.startswith("subm_conv_mma_kernel<") and args[1] == "0":
            print(f"[{tag}] ptxas: {ptxas_line(name, stats)} (+ "
                  f"{conv_tile(int(args[0])).smem} B dynamic smem, conv_tile)")
        elif name.startswith("subm_conv_wgrad_mma_kernel<"):
            print(f"[{tag}] ptxas: {ptxas_line(name, stats)} (+ "
                  f"{wgrad_smem(*map(int, args))} B dynamic smem, wgrad_tile)")
    for (lvl, cin, cout), calls in sorted(conv_shapes(planes).items()):
        nbr = torch.from_numpy(pack_np.neighbors[lvl]).to(dev)
        v, n = nbr.shape[0], pack_np.n_valid[lvl]

        def rand(*shape, scale=1.0):
            x = torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32))
            if shape[0] == v:
                x[n:] = 0.0
            return x.to(dev, torch.bfloat16)

        feat, g = rand(v, cin), rand(v, cout)
        w = rand(27, cin, cout, scale=1 / np.sqrt(27 * cin))
        w_mirror = w.flip(0).transpose(1, 2).contiguous()
        pad_f = torch.cat([feat, feat.new_zeros(1, cin)])
        pad_g = torch.cat([g, g.new_zeros(1, cout)])
        idx = nbr[:n].reshape(-1).long()
        pairs = int((nbr[:n] < v).sum().item())
        ops_ms = 2.0 * pairs * cin * cout / BF16_FLOPS * 1e3
        # The input conv's input is data: no K1' for it.
        dgrad_calls = calls - (1 if cin == 6 else 0)
        # name: (kernel, plain, library yardstick: gather + one bf16 GEMM,
        #        bytes moved, calls per forward or step)
        work = {
            "subm_conv": (
                lambda: subm_conv_cuda(feat, nbr, w, n),
                lambda: subm_conv(feat, nbr, w, n),
                lambda: pad_f.index_select(0, idx).view(n, 27 * cin)
                @ w.view(27 * cin, cout),
                n * 27 * 4 + n * cin * 2 + 27 * cin * cout * 2 + v * cout * 4, calls),
            "subm_conv_dgrad": (
                lambda: subm_conv_dgrad_cuda(g, nbr, w, n),
                lambda: subm_conv_dgrad(g, nbr, w, n),
                lambda: pad_g.index_select(0, idx).view(n, 27 * cout)
                @ w_mirror.view(27 * cout, cin),
                n * 27 * 4 + n * cout * 2 + 27 * cin * cout * 2 + v * cin * 4, dgrad_calls),
            "subm_conv_wgrad": (
                lambda: subm_conv_wgrad_cuda(feat, nbr, g, n),
                lambda: subm_conv_wgrad(feat, nbr, g, n),
                lambda: torch.mm(pad_f.index_select(0, idx).view(n, 27 * cin).T, g[:n]),
                n * 27 * 4 + n * cin * 2 + n * cout * 2 + 27 * cin * cout * 4, calls),
        }
        row = {}
        for name in names:
            kernel, plain, library, nbytes, n_calls = work[name]
            if not n_calls:
                continue
            out, ref = kernel(), plain()
            torch.cuda.synchronize()
            # The same bf16 products summed in fp32 in another order; dW
            # entries sum up to ~n products, so their tolerance scales with
            # the largest entry.
            scale = 1.0 if name != "subm_conv_wgrad" else max(1.0, ref.abs().max().item())
            torch.testing.assert_close(out, ref, rtol=1e-3, atol=1e-3 * scale)
            # No split-K atomics: the same bits on a second launch.
            assert torch.equal(out, kernel()), f"{name} {cin}->{cout}: not bit-equal on repeat"
            err = (out - ref).abs().max().item()
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            t = tot[name]
            t["max_abs_err"] = max(t["max_abs_err"], err)
            # Median of 5 rounds of 3 launches, so that one slow window does
            # not set a shape's time.
            ms = statistics.median(cuda_ms(kernel, reps=3) for _ in range(5))
            plain_ms = cuda_ms(plain, reps=1)
            library_ms = cuda_ms(library, reps=1)
            for key, val in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", library_ms),
                             ("bound_ms", max(bytes_ms, ops_ms)), ("bytes_ms", bytes_ms),
                             ("ops_ms", ops_ms)):
                t[key] += n_calls * val
            row[name] = (f"{ms:.3f}/{plain_ms:.3f}/{library_ms:.3f}/"
                         f"{max(bytes_ms, ops_ms):.4f} err {err:.1e}"
                         + (" SLOWER than index_select+mm" if ms > library_ms else ""))
        if backward:
            tile = wgrad_tile(cin, cout)
            row["subm_conv_wgrad"] += (f" (tile {tile.cin_tile}x{tile.cout_tile}, "
                                       f"{tile.group} offsets, {tile.acc} acc)")
        print(f"[{tag}] level {lvl} {cin}->{cout} x{calls}: rows {n} pairs {pairs} "
              f"kernel/plain/index_select+mm/bound ms: " + ", ".join(
                  f"{k} {r}" for k, r in row.items()) + f" | {card}")
    for name, t in tot.items():
        t["bound_by"] = "bytes" if t.pop("bytes_ms") >= t.pop("ops_ms") else "operations"
        print(f"[{tag}] {name} per {'step' if backward else 'forward'}: kernel "
              f"{t['ms']:.1f} ms plain {t['plain_ms']:.1f} ms index_select+mm "
              f"{t['library_ms']:.1f} ms bound {t['bound_ms']:.3f} ms ({t['bound_by']}) "
              f"| {card}")
    return tot


def check_attention(q, k, v, do, seg, scale, backward):
    """K3 (with `backward`: its logsumexp, K3-dkv and K3-dq) on q, k, v, do
    against the plain versions, each output within `attention_tol(ref)`; K3
    gives the same o without the logsumexp and the same bits on a second
    launch. Returns the max abs error per kernel (with `backward` also per
    output: dq, dk, dv), the forward's o and lse, and with `backward` the
    kernels' (dq, dk, dv)."""
    o, lse = flash_attention_cuda(q, k, v, seg, scale, return_lse=True)
    ref_o, ref_lse = attention_plain(q, k, v, seg, scale, return_lse=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(o.float(), ref_o.float(), **attention_tol(ref_o), msg="o")
    again, lse_again = flash_attention_cuda(q, k, v, seg, scale, return_lse=True)
    assert torch.equal(o, flash_attention_cuda(q, k, v, seg, scale)), "o differs without lse"
    assert torch.equal(o, again) and torch.equal(lse, lse_again), "K3 not bit-equal on repeat"
    errs = {"flash_attention": (o.float() - ref_o.float()).abs().max().item()}
    if not backward:
        return errs, o, lse, None
    torch.testing.assert_close(lse, ref_lse, rtol=1e-4, atol=1e-4)
    di = (o.float() * do.float()).sum(-1)
    dk, dv = flash_attention_dkv_cuda(q, k, v, seg, do, lse, di, scale)
    dq = flash_attention_dq_cuda(q, k, v, seg, do, lse, di, scale)
    ref = attention_bwd_plain(q, k, v, seg, do, lse, di, scale)
    torch.cuda.synchronize()
    for name, mine, r in (("dq", dq, ref[0]), ("dk", dk, ref[1]), ("dv", dv, ref[2])):
        assert mine.dtype == q.dtype, name
        torch.testing.assert_close(mine.float(), r.float(), **attention_tol(r),
                                   msg=lambda m, n=name: f"{n}: {m}")
        errs[name] = (mine.float() - r.float()).abs().max().item()
    errs["flash_attention_dq"] = errs["dq"]
    errs["flash_attention_dkv"] = max(errs["dk"], errs["dv"])
    return errs, o, lse, (dq, dk, dv)


def sdpa_backward_check(q, k, v, do, seg, scale, grads, sdpa, errs, card):
    """The bf16 kernels' (dq, dk, dv) `grads` and SDPA's, `sdpa`, each
    against the fp32 plain backward of the same bf16 inputs (the exact
    backward of those inputs); asserts that each kernel output's error
    against its plain version (`errs`) is at most twice SDPA's error there."""
    q32, k32, v32, do32 = (x.float() for x in (q, k, v, do))
    o32, lse32 = attention_plain(q32, k32, v32, seg, scale, return_lse=True)
    ref32 = attention_bwd_plain(q32, k32, v32, seg, do32, lse32, (o32 * do32).sum(-1),
                                scale)
    del q32, k32, v32, do32, o32
    mine32, sdpa32 = ([(a.float() - r).abs().max().item() for a, r in zip(out, ref32)]
                      for out in (grads, sdpa))
    fmt = lambda xs: ", ".join(f"{x:.3e}" for x in xs)  # noqa: E731
    print(f"[K3-train] max abs error (dq, dk, dv) against the fp32 plain backward: "
          f"kernels {fmt(mine32)}, SDPA {fmt(sdpa32)}; kernels against the bf16 plain "
          f"version {fmt(errs[n] for n in ('dq', 'dk', 'dv'))} | {card}")
    for name, sdpa_err in zip(("dq", "dk", "dv"), sdpa32):
        assert errs[name] <= 2 * sdpa_err, (name, errs[name], sdpa_err)


def phase_attention(n_valid, s, card, backward, ptxas=()):
    """K3 -- and with `backward` also its logsumexp, K3-dkv and K3-dq --
    against the plain versions at the decoder's shape (B = len(n_valid),
    H=8, L=s, head dim 32) in bf16, and with `backward` the same kernels'
    fp32 route at the same shape and the bf16 kernels' and SDPA's backward
    against the fp32 plain backward; prints the registers, spills and shared
    memory of the phase's kernels (`ptxas`: their sources' ptxas_report
    entries). Returns per-call numbers per kernel."""
    tag = "K3-train" if backward else "K3"
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    b, h, hd = len(n_valid), 8, 32
    inputs = [torch.randn(b, h, s, hd, generator=gen, device=dev) for _ in range(4)]
    seg = torch.full((b, s), 2, dtype=torch.int32, device=dev)
    for i, n in enumerate(n_valid):
        seg[i, :n] = 1
    scale = 1.0 / hd ** 0.5
    if backward:  # fp32: the same sums in another order, 1e-4 as in the card tests
        errs32 = check_attention(*inputs, seg, scale, True)[0]
    q, k, v, do = (x.to(torch.bfloat16) for x in inputs)
    del inputs
    errs, o, lse, grads = check_attention(q, k, v, do, seg, scale, backward)
    di = (o.float() * do.float()).sum(-1)
    mask = seg[:, None, :, None] == seg[:, None, None, :]
    if backward:
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        sdpa_out = F.scaled_dot_product_attention(*leaves, attn_mask=mask, scale=scale)
        sdpa_backward_check(q, k, v, do, seg, scale, grads,
                            torch.autograd.grad(sdpa_out, leaves, do, retain_graph=True),
                            errs, card)
        del grads
    for name, stats in ptxas:
        print(f"[{tag}] ptxas: {ptxas_line(name, stats)}")

    times = {"flash_attention": (
        cuda_ms(lambda: flash_attention_cuda(q, k, v, seg, scale, return_lse=backward)),
        cuda_ms(lambda: attention_plain(q, k, v, seg, scale, return_lse=backward), reps=2),
        cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                       scale=scale), reps=2))}
    if backward:
        times["flash_attention_dkv"] = (
            cuda_ms(lambda: flash_attention_dkv_cuda(q, k, v, seg, do, lse, di, scale)),
            cuda_ms(lambda: attention_bwd_plain(q, k, v, seg, do, lse, di, scale), reps=2),
            cuda_ms(lambda: torch.autograd.grad(sdpa_out, leaves, do, retain_graph=True),
                    reps=2))
        times["flash_attention_dq"] = (
            cuda_ms(lambda: flash_attention_dq_cuda(q, k, v, seg, do, lse, di, scale)),
            *times["flash_attention_dkv"][1:])
    # Pairs the masks need; per pair, the products each kernel's output needs
    # (forward s, pv: 2; dkv s, dp, dv, dk: 4; dq s, dp, dq: 3) and one exp,
    # which the SFUs take at 16 per clock per SM.
    pairs = sum(n * n + (s - n) * (s - n) for n in n_valid) * h
    exps_ms = pairs / (torch.cuda.get_device_properties(0).multi_processor_count
                       * SFU_EXP_PER_CLOCK * sm_clock_hz()) * 1e3
    bhs = b * h * s
    work = {
        "flash_attention": (2, 4 * bhs * hd * 2 + (bhs * 4 if backward else 0) + b * s * 4),
        "flash_attention_dkv": (4, 6 * bhs * hd * 2 + 2 * bhs * 4 + b * s * 4),
        "flash_attention_dq": (3, 5 * bhs * hd * 2 + 2 * bhs * 4 + b * s * 4),
    }
    out = {}
    for name, (ms, plain_ms, library_ms) in times.items():
        products, nbytes = work[name]
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = max(2.0 * products * pairs * hd / BF16_FLOPS * 1e3, exps_ms)
        out[name] = dict(max_abs_err=errs[name], ms=ms, plain_ms=plain_ms,
                         library_ms=library_ms, bound_ms=max(bytes_ms, ops_ms),
                         bound_by="bytes" if bytes_ms >= ops_ms else "operations")
        fp32 = f" (fp32 route {errs32[name]:.2e})" if backward else ""
        print(f"[{tag}] {name}: B {b} H {h} L {s} valid {list(n_valid)}: bf16 err "
              f"{errs[name]:.2e}{fp32} kernel {ms:.3f} ms plain {plain_ms:.3f} ms "
              f"sdpa {library_ms:.3f} ms bound {out[name]['bound_ms']:.4f} ms per call "
              f"(products {2.0 * products * pairs * hd / BF16_FLOPS * 1e3:.4f}, exps "
              f"{exps_ms:.4f}, bytes {bytes_ms:.4f}) | {card}")
    if backward:
        print(f"[{tag}] the plain and SDPA backward times each cover dq, dk and dv "
              "together; SDPA's are with a boolean mask")
    return out


def phase_sp_trim(card, ptxas=()):
    """[sp-trim]: the trimming kernel against trim_boxes_by_superpoints (on
    the card, scene by scene) at the eval path's shapes, yaw 0, bit for bit
    and again on a second launch, then its ms per group of 4 (CUDA events;
    one launch for the group, as predict_batch makes it), the plain
    version's, and its bound: the inside test of every (valid point, box)
    pair over the fp32 lanes at the card's clock, against the bytes it must
    read and write. Returns the `kernels` line's numbers."""
    tag = "sp-trim"
    cfg = default_config()
    dev = torch.device("cuda")
    points, valid, sp_ids, boxes = (torch.from_numpy(x).to(dev) for x in trim_group(seed=0))
    b, p, k, s = *points.shape[:2], boxes.shape[1], cfg.max_superpoints
    keep = torch.ones((b, k), dtype=torch.bool, device=dev)

    def kernel():
        return sp_trim_cuda(points, valid, sp_ids, boxes, s, cfg.low_sp_thr, cfg.up_sp_thr)

    def plain():
        return [trim_boxes_by_superpoints(cfg, *args)
                for args in zip(boxes, keep, points, valid, sp_ids)]

    before = sp_trim_cuda.launches
    out, has = kernel()
    torch.cuda.synchronize()
    assert sp_trim_cuda.launches - before == 1
    ref = plain()
    assert torch.equal(has, torch.stack([r[1] for r in ref])), tag
    assert torch.equal(out, torch.stack([r[0] for r in ref])), tag
    again = kernel()
    assert torch.equal(again[0], out) and torch.equal(again[1], has), tag
    for name, stats in ptxas:
        print(f"[{tag}] ptxas: {ptxas_line(name, stats)}")
    ms = cuda_ms(kernel, reps=20)
    plain_ms = cuda_ms(plain, reps=2)
    pairs = sum(TRIM_VALID) * k
    ops_ms = pairs * TRIM_OPS_PER_PAIR / (
        torch.cuda.get_device_properties(0).multi_processor_count * FP32_LANES
        * sm_clock_hz()) * 1e3
    # Points, validity and ids read; boxes read and written, has written.
    nbytes = b * p * (3 * 4 + 1 + 4) + b * k * (7 * 4 * 2 + 1)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    num = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=None,
               bound_ms=max(ops_ms, bytes_ms),
               bound_by="operations" if ops_ms >= bytes_ms else "bytes")
    print(f"[{tag}] {b} scenes x {p} slots ({list(TRIM_VALID)} valid), K {k}, S {s}: "
          f"equal to the plain version bit for bit ({int(has.sum())} boxes keep a point), "
          f"and on a second launch; kernel {ms:.3f} ms plain {plain_ms:.1f} ms per group, "
          f"bound {num['bound_ms']:.4f} ms (operations {ops_ms:.4f}: {pairs} pairs x "
          f"{TRIM_OPS_PER_PAIR}; bytes {bytes_ms:.4f}: {nbytes}) | {card}")
    return num


def phase_pool(card, ptxas=()):
    """[pool]: G1, the point-to-superpoint pooling, at the staged training
    cell's shapes (data/synthetic.py::pool_batch: 8 scenes of 196,608
    slots, 885,000 valid points, ~44 % padding, C 32, S 3072): forward and
    backward equal to the plain path on the CPU (the gather and segment
    mean that pool_superpoints ran before, autograd's backward) bit for
    bit, again on a second call in PyTorch's deterministic mode; then each
    direction's ms (CUDA events) beside its bound, the plain path's on the
    card and the library yardstick's (index_select, whose backward is
    index_add_, then the same segment mean). Returns the `kernels` line's
    numbers, per training step (one call each way)."""
    tag = "pool"
    dev = torch.device("cuda")
    feats, pinv, sp_flat, n = pool_batch(seed=0)
    feats, pinv, sp_flat = (torch.from_numpy(x).to(dev) for x in (feats, pinv, sp_flat))
    v0, c = feats.shape
    cot = torch.randn((n, c), generator=torch.Generator(device=dev).manual_seed(0), device=dev)

    def g1_fwd():
        return point_pool_cuda(feats, pinv, sp_flat, n)

    mean, counts = g1_fwd()

    def g1_bwd():
        return point_pool_bwd_cuda(cot, counts, pinv, sp_flat, v0)

    def plain_fwd():
        x = feats.detach().requires_grad_()
        return x, point_pool_plain(x, pinv, sp_flat, n)[0]

    def plain_both():
        x, m = plain_fwd()
        m.backward(cot)
        return x.grad

    def library_both():
        x = feats.detach().requires_grad_()
        rows = torch.cat([x, x.new_zeros((1, c))]).index_select(0, pinv)
        total = torch.zeros((n + 1, c), device=dev).index_add_(0, sp_flat.clamp(max=n), rows)
        (total[:n] / counts[:, None].clamp(min=1.0)).backward(cot)
        return x.grad

    grad = g1_bwd()
    x = feats.cpu().requires_grad_()
    ref, ref_counts = point_pool_plain(x, pinv.cpu(), sp_flat.cpu(), n)
    ref.backward(cot.cpu())
    got = [t.cpu() for t in (mean, counts, grad)]
    torch.use_deterministic_algorithms(True)
    try:
        again = [t.cpu() for t in (*g1_fwd(), g1_bwd())]
    finally:
        torch.use_deterministic_algorithms(False)
    want = (ref.detach(), ref_counts, x.grad)
    for name, w, first, second in zip(("mean", "counts", "grad"), want, got, again):
        assert torch.equal(first, w) and torch.equal(second, w), (tag, name)
    card_plain = plain_both()
    max_abs_err = 0.0  # bit for bit against the CPU
    for name, stats in ptxas:
        print(f"[{tag}] ptxas: {ptxas_line(name, stats)}")
    fwd_ms, bwd_ms = cuda_ms(g1_fwd, reps=20), cuda_ms(g1_bwd, reps=20)
    plain_fwd_ms = cuda_ms(plain_fwd, reps=3)
    plain_ms = cuda_ms(plain_both, reps=3)
    library_ms = cuda_ms(library_both, reps=3)
    n_slots, n_valid = len(pinv), int((sp_flat < n).sum())
    used_rows = int(torch.unique(pinv[pinv < v0]).numel())
    # Each input byte read once, each output byte written once: forward the
    # index arrays, the voxel rows the points reach, the means and counts;
    # backward the index arrays, the cotangent and counts, the whole gradient.
    fwd_bytes = n_slots * 12 + used_rows * c * 4 + n * (c + 1) * 4
    bwd_bytes = n_slots * 12 + n * (c + 1) * 4 + v0 * c * 4
    fwd_bound, bwd_bound = (nb / HBM_BYTES_PER_S * 1e3 for nb in (fwd_bytes, bwd_bytes))
    num = dict(max_abs_err=max_abs_err, ms=fwd_ms + bwd_ms, plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=fwd_bound + bwd_bound, bound_by="bytes",
               fwd_ms=fwd_ms, bwd_ms=bwd_ms)
    print(f"[{tag}] {len(POOL_VALID)} scenes x {n_slots // len(POOL_VALID)} slots "
          f"({n_valid} valid, {1 - n_valid / n_slots:.1%} padding), {used_rows} voxels of "
          f"{v0}, C {c}, {n} superpoint slots: mean, counts and gradient equal the CPU's "
          f"plain path bit for bit, twice (the second in deterministic mode); the card's "
          f"plain gradient differs from the CPU's by up to "
          f"{(card_plain.cpu() - x.grad).abs().max().item():.3g} | {card}")
    print(f"[{tag}] G1 forward {fwd_ms:.4f} ms (bound {fwd_bound:.4f}: {fwd_bytes} B), "
          f"backward {bwd_ms:.4f} ms (bound {bwd_bound:.4f}: {bwd_bytes} B), each with its "
          f"sort; plain path forward {plain_fwd_ms:.3f} ms, forward + backward "
          f"{plain_ms:.2f} ms; library (index_select / index_add_) forward + backward "
          f"{library_ms:.2f} ms | {card}")
    return num


def phase_e2e_small(table, card):
    """Card forward (kernels) vs CPU forward (plain versions), fp32."""
    n_points = 16384
    cfg = default_config(compute_dtype="float32", max_points=n_points,
                         voxel_capacity=n_points, max_superpoints=512)
    batch, _, pack = collate(make_scenes(1, n_points, seed0=100), cfg)
    ref_net = seeded_init_(UniDet3D(cfg, table, device="cpu"), 0)
    net = UniDet3D(cfg, table, device="cuda")
    net.load_state_dict(ref_net.state_dict())
    with torch.no_grad():
        ref, ref_aux = ref_net(*to_device(batch, pack, "cpu"))
        k1, k3 = subm_conv_cuda.launches, flash_attention_cuda.launches
        out, aux = net(*to_device(batch, pack, "cuda"))
    torch.cuda.synchronize()
    assert subm_conv_cuda.launches - k1 == 37, "card forward did not run K1 37 times"
    assert flash_attention_cuda.launches - k3 == 6, "card forward did not run K3 6 times"
    valid = ref_aux.query_valid[0]
    assert torch.equal(aux.query_valid[0].cpu(), valid)
    errs = {}
    for name in ("cls_logits", "boxes"):
        a = getattr(out, name)[-1, 0].cpu()[valid]
        b = getattr(ref, name)[-1, 0][valid]
        # fp32 on both sides; sums in other orders through 37 convs and 6
        # attention layers: relative error well under 1e-3 of the scale.
        scale = max(1.0, b.abs().max().item())
        err = (a - b).abs().max().item()
        assert err <= 1e-3 * scale, f"{name}: card vs CPU max abs err {err} (scale {scale})"
        errs[name] = err
    print(f"[e2e-small] 1 scene x {n_points} pts, fp32, {int(valid.sum())} valid "
          f"queries: card vs CPU max abs err logits {errs['cls_logits']:.2e} "
          f"boxes {errs['boxes']:.2e} | {card}")


def phase_production(samples, table, card, dataset_idx=0, tag="prod", reps=3):
    """The production eval path at full width on one group of `samples` of
    dataset `dataset_idx`: the kernel launches of one run counted from
    zero, its outputs checked, then its metrics (for a rotated dataset also
    the card time of pairwise_iou_rotated over the group's selected boxes).
    Returns the counted run's device batch and decoder outputs, and its
    trimming launches."""
    cfg = default_config()  # full width, bf16, S = 3072, 163840 voxels/scene
    t0 = time.time()
    batch, _, pack = collate(samples, cfg)
    pack_s = time.time() - t0
    net = seeded_init_(UniDet3D(cfg, table, device="cuda"), 0)

    @torch.no_grad()
    def run():
        b, p = to_device(batch, pack, "cuda")
        out, aux = net(b, p)
        det = predict_batch(cfg, dataset_idx, out.cls_logits[-1], out.boxes[-1],
                            aux.query_valid, b.points, b.valid, b.sp_ids)
        torch.cuda.synchronize()
        return b, out, aux, det

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    trims, pools = sp_trim_cuda.launches, pool_calls()
    b_run, out_run, aux_run, det = run()  # the main-path run whose launches are counted
    launches = read_counts()
    assert launches == dict(NO_LAUNCHES, subm_conv=37, flash_attention=6), (tag, launches)
    assert np.subtract(pool_calls(), pools).tolist() == [1, 0], (tag, pools, pool_calls())
    trims = sp_trim_cuda.launches - trims
    assert trims == (1 if cfg.use_superpoints[dataset_idx] else 0), (tag, trims)
    out, aux = out_run, aux_run
    nq = cfg.max_superpoints
    assert out.cls_logits.shape == (cfg.num_layers + 1, GROUP, nq, 85)
    assert out.boxes.shape == (cfg.num_layers + 1, GROUP, nq, 7)
    qv = aux.query_valid
    assert torch.isfinite(out.cls_logits[:, qv]).all()
    assert torch.isfinite(out.boxes[:, qv]).all()
    assert det.boxes.shape == (GROUP, cfg.topk_insts, 7)
    kept = int(det.valid.sum().item())
    assert kept > 0 and torch.isfinite(det.boxes[det.valid]).all()
    rotated = cfg.angles[dataset_idx]
    if rotated:  # detections keep their yaw
        assert det.boxes[det.valid, 6].abs().max() > 0

    group, h2d, fwd, post = [], [], [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        b, p = to_device(batch, pack, "cuda")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with torch.no_grad():
            out, aux = net(b, p)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            predict_batch(cfg, dataset_idx, out.cls_logits[-1], out.boxes[-1],
                          aux.query_valid, b.points, b.valid, b.sp_ids)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        group.append((t3 - t0) * 1e3)
        h2d.append((t1 - t0) * 1e3)
        fwd.append((t2 - t1) * 1e3)
        post.append((t3 - t2) * 1e3)
    g = statistics.median(group)
    n_sp = int(aux.query_valid.sum().item())
    print(f"[{tag}] {GROUP} scenes x {SCENE_POINTS} pts (dataset {cfg.datasets[dataset_idx]}), "
          f"voxels/level {list(pack.n_valid)}, {n_sp} valid queries | {card}")
    print(f"[{tag}] host pack (native rulebooks) {pack_s:.2f} s | {card}")
    print(f"[{tag}] warm median group {g:.1f} ms over {reps} runs "
          f"({GROUP / (g / 1e3):.2f} scenes/s): H2D {statistics.median(h2d):.1f} ms, "
          f"forward {statistics.median(fwd):.1f} ms, post-processing "
          f"{statistics.median(post):.1f} ms, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB | {card}")
    print(f"[{tag}] launches per forward: K1 {launches['subm_conv']}, "
          f"K3 {launches['flash_attention']}, trimming {trims}; detections kept {kept} "
          f"| {card}")
    if rotated:
        iou_ms = cuda_ms(lambda: [pairwise_iou_rotated(x) for x in det.boxes], reps=3)
        print(f"[{tag}] pairwise_iou_rotated over the group's {GROUP} x {cfg.topk_insts} "
              f"selected boxes: {iou_ms:.2f} ms of card time per group (CUDA events, mean "
              f"of 3) | {card}")
        phase_profile(lambda: ([pairwise_iou_rotated(x) for x in det.boxes],
                               torch.cuda.synchronize()),
                      card, f"pairwise_iou_rotated of one group ({tag})", top=6)
    phase_profile(run, card, f"one group ({tag})")
    return (b_run, out_run, aux_run), trims


def map_inputs(cfg, dataset_idx, out, aux, b, device):
    """predict_batch's inputs from a group's decoder outputs, on `device`."""
    return (cfg, dataset_idx, *(x.to(device) for x in (
        out.cls_logits[-1], out.boxes[-1], aux.query_valid, b.points, b.valid, b.sp_ids)))


def phase_map(groups, card):
    """The eval end on the card against the CPU: each group's decoder
    outputs (groups: [(dataset index, samples with GT, device batch,
    decoder outputs, aux)]) go through predict_batch on the card and, moved
    over, on the CPU. The keep masks must agree except at detections that
    an order swap of near-equal scores moved, or that have a same-class IoU
    within 1e-4 of the dataset's iou_thr among the selected boxes; then
    IndoorMetric.compute must give the same mAP@0.25 / 0.50 from both."""
    cfg = default_config()
    metrics = {dev: IndoorMetric(cfg, DATASETS_CLASSES) for dev in ("cuda", "cpu")}
    swapped = ambiguous = differ = 0
    for ds, samples, b, out, aux in groups:
        thr = cfg.iou_thr[ds]
        dets = {dev: predict_batch(*map_inputs(cfg, ds, out, aux, b, dev))
                for dev in ("cuda", "cpu")}
        for i, sample in enumerate(samples):
            sel = {dev: select_topk_instances(out.cls_logits[-1, i].to(dev),
                                              out.boxes[-1, i].to(dev),
                                              aux.query_valid[i].to(dev), cfg.topk_insts)
                   for dev in ("cuda", "cpu")}
            boxes, labels, scores = sel["cpu"]
            moved = ((sel["cuda"][1].cpu() != labels)
                     | (sel["cuda"][0].cpu() != boxes).any(-1))
            if moved.any():  # only where the scores tie to within 1e-6
                assert (sel["cuda"][2].cpu() - scores)[moved].abs().max() <= 1e-6, (ds, i)
            iou = pairwise_iou_rotated(boxes) if cfg.angles[ds] else pairwise_iou_aa(boxes)
            near = ((iou - thr).abs() < 1e-4) & (labels[:, None] == labels[None, :])
            near.fill_diagonal_(False)
            near = near.any(1)
            keep = {dev: d.valid[i].cpu() for dev, d in dets.items()}
            bad = (keep["cuda"] != keep["cpu"]) & ~moved & ~near
            assert not bad.any(), (ds, i, int(bad.sum()))
            swapped += int(moved.sum())
            ambiguous += int(near.sum())
            differ += int((keep["cuda"] != keep["cpu"]).sum())
            gt_boxes = np.zeros((len(sample["gt_bboxes_3d"]), 7), np.float32)
            gt_boxes[:, :sample["gt_bboxes_3d"].shape[1]] = sample["gt_bboxes_3d"]
            for dev, d in dets.items():
                metrics[dev].process(ds, *(x[i].cpu().numpy() for x in d), gt_boxes,
                                     sample["gt_labels_3d"])
    res = {dev: m.compute(logger=None) for dev, m in metrics.items()}
    for name, ref in res["cpu"].items():
        vals = {k: (res["cuda"][name][k], ref[k]) for k in ("mAP_0.25", "mAP_0.50")}
        for k, (a, r) in vals.items():
            assert abs(a - r) <= 1e-6, (name, k, a, r)
        print(f"[map] {name}: card " + ", ".join(f"{k} {a:.6f}" for k, (a, _) in vals.items())
              + "; CPU " + ", ".join(f"{k} {r:.6f}" for k, (_, r) in vals.items())
              + f" ({GROUP} scenes) | {card}")
    print(f"[map] keep masks card vs CPU: {differ} of {len(groups) * GROUP * cfg.topk_insts} "
          f"detections differ, all among the {swapped} moved by order swaps of near-equal "
          f"scores and the {ambiguous} with a same-class IoU within 1e-4 of iou_thr. The "
          f"weights are random: these mAP values say nothing about accuracy, only that card "
          f"and CPU agree | {card}")


def phase_profile(run, card, what, top=12):
    """`run` once under torch.profiler: device time by kernel and the
    device's idle share of its wall time. Returns the idle share."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted(
        (e.time_range.start, e.time_range.end) for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
    )
    busy_us, cur_start, cur_end = 0.0, None, None
    for start, end in spans:  # union of device intervals
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                busy_us += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        busy_us += cur_end - cur_start
    assert busy_us > 0, "the profiler saw no device activity"
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n, t = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, t + e.time_range.elapsed_us())
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    idle = 1.0 - busy_us / wall_us
    print(f"[profile] {what}: wall {wall_us / 1e3:.1f} ms, device busy "
          f"{busy_us / 1e3:.1f} ms, idle share {idle:.3f} (profiler on) | {card}")
    for name, (n, us) in rows:
        print(f"[profile]   {us / 1e3:8.2f} ms  x{n:<5d} {name[:90]}")
    return idle


def train_scenes(n_scenes, n_points, seed0, n_gts, datasets=None):
    """Synthetic training scenes with ground truth. `datasets` gives each
    scene's dataset index; by default the first half take ScanNet's flags
    (host superpoint masks, boxes from instance masks), the rest MultiScan's
    (raw boxes, distance top-k masks). Instance k is the run of SP_PER_GT
    consecutive stripe superpoints from k * SP_PER_GT, its box the bounds of
    its points; an ARKitScenes scene's boxes also get a yaw each, drawn
    uniformly in [-pi, pi) from the scene's seed."""
    if datasets is None:
        datasets = [0 if i < n_scenes // 2 else 2 for i in range(n_scenes)]
    samples = []
    for i, ds in enumerate(datasets):
        rng = np.random.RandomState(seed0 + i)
        pts = synthetic_scene(n_points, seed=seed0 + i)
        sp = stripe_superpoints(pts, SP_SIZE)
        inst_of_sp = np.full(int(sp.max()) + 1, -1)
        inst_of_sp[: n_gts * SP_PER_GT] = np.arange(n_gts * SP_PER_GT) // SP_PER_GT
        inst = inst_of_sp[sp]
        lo = np.stack([pts[inst == k, :3].min(0) for k in range(n_gts)])
        hi = np.stack([pts[inst == k, :3].max(0) for k in range(n_gts)])
        boxes = np.concatenate([(lo + hi) / 2, hi - lo], 1).astype(np.float32)
        labels = rng.randint(0, len(DATASETS_CLASSES[ds]), n_gts)
        if ds == ARKIT:
            yaw = rng.uniform(-np.pi, np.pi, (n_gts, 1)).astype(np.float32)
            boxes = np.concatenate([boxes, yaw], 1)
        samples.append({
            "points": pts, "dataset_idx": ds, "sp_pts_mask": sp,
            "gt_bboxes_3d": boxes, "gt_labels_3d": labels,
            "gt_sp_masks": inst_of_sp[None, :] == np.arange(n_gts)[:, None],
            "pts_instance_mask": inst,
        })
    return samples


def grad_ratios(mine: dict, ref: dict) -> list:
    """[(error / bound, name)] over the named gradients, largest first: the
    backbone's in norm, |a - b| <= BACKBONE_RTOL |b| + 1e-8, the rest
    elementwise, max|a - b| <= HEAD_RTOL max|b| + 1e-8."""
    assert mine.keys() == ref.keys()
    rows = []
    for name, b in ref.items():
        d = mine[name] - b
        if name.startswith("backbone."):
            rows.append((d.norm().item() / (BACKBONE_RTOL * b.norm().item() + 1e-8), name))
        else:
            rows.append((d.abs().max().item() / (HEAD_RTOL * b.abs().max().item() + 1e-8),
                         name))
    return sorted(rows, reverse=True)


def worst_by_part(rows: list) -> str:
    """The worst (ratio, name) of the backbone's gradients and of the rest."""
    parts = {"backbone": [r for r in rows if r[1].startswith("backbone.")],
             "rest": [r for r in rows if not r[1].startswith("backbone.")]}
    return ", ".join(f"{part} {r[0][0]:.3f} ({r[0][1]})" for part, r in parts.items())


def small_train(table, datasets, seed0):
    """Two small training scenes of `datasets` at full width, fp32, and a
    function running one training step on them from the same weights and
    the same query draw: one(device) -> (loss, grad_norm, {name: grad})."""
    n_points = 8192
    cfg = default_config(compute_dtype="float32", max_points=n_points,
                         voxel_capacity=n_points, max_superpoints=256, max_gts=16,
                         query_thr=160)
    batch, gt, pack = collate(train_scenes(2, n_points, seed0, n_gts=8, datasets=datasets), cfg)
    init = seeded_init_(UniDet3D(cfg, table, device="cpu"), 0).state_dict()

    def one(device):
        model = UniDet3D(cfg, table, device=device)
        model.load_state_dict(init)
        step = make_train_step(model, cfg, make_optimizer(model.parameters()))
        b, p = to_device(batch, pack, device)
        m = step(b, gt_to_device(gt, device), p, torch.Generator().manual_seed(3),
                 host_dataset_ids=batch.dataset_ids)
        grads = {n: x.grad.detach().cpu() for n, x in model.named_parameters()}
        return float(m["loss"]), float(m["grad_norm"]), grads

    return cfg, batch, gt, pack, init, one


def deterministic_card_step(one):
    """one("cuda") in PyTorch's deterministic mode, with its launches
    counted from zero: (loss, grad_norm, grads, launches)."""
    torch.use_deterministic_algorithms(True)
    try:
        reset_counts()
        loss, norm, grads = one("cuda")
        torch.cuda.synchronize()
        return loss, norm, grads, read_counts()
    finally:
        torch.use_deterministic_algorithms(False)


def assert_card_step_like_cpu(tag, card_step, cpu_step, vs_cpu):
    """The bounds of a card training step against the CPU's: the launches
    of a step, the loss within 1e-5 and the gradient norm within 1e-4 of
    the CPU's, every gradient within its grad_ratios bound."""
    loss, norm, _, launches = card_step
    loss_ref, norm_ref, _ = cpu_step
    assert launches == TRAIN_LAUNCHES, (tag, launches)
    assert abs(loss - loss_ref) <= 1e-5 * abs(loss_ref), (tag, loss, loss_ref)
    assert abs(norm - norm_ref) <= 1e-4 * norm_ref, (tag, norm, norm_ref)
    ratio, name = vs_cpu[0]
    assert ratio <= 1.0, f"{tag}: card vs CPU gradient {name}: {ratio:.3f} of its bound"


def phase_train_small(table, card):
    """One fp32 training step at full width on two small scenes, from the
    same weights and the same query draw, on the CPU (plain versions) and
    NOISE_STEPS + 2 times on the card (kernels). The first NOISE_STEPS card
    steps run with PyTorch's default algorithms (index_add_ sums with
    atomics): the worst difference between two successive ones is the
    card's run-to-run noise. The last two run in deterministic mode, must
    agree bit for bit, and the first of them is held against the CPU."""
    cfg, *_, one = small_train(table, None, 300)
    cpu_step = one("cpu")
    noisy = [one("cuda")[2] for _ in range(NOISE_STEPS)]
    card_step = deterministic_card_step(one)
    repeat = deterministic_card_step(one)[2]
    loss, norm, grads, _ = card_step
    changed = [n for n in grads if not torch.equal(grads[n], repeat[n])]
    noise = sorted(r for a, b in zip(noisy, noisy[1:]) for r in grad_ratios(a, b))[::-1]
    vs_cpu = grad_ratios(grads, cpu_step[2])
    print(f"[train-small] 2 scenes x {cfg.max_points} pts, fp32, full width: loss card "
          f"{loss:.6f} CPU {cpu_step[0]:.6f}, grad_norm card {norm:.5f} CPU "
          f"{cpu_step[1]:.5f}; deterministic repeat differs in {len(changed)} of "
          f"{len(grads)} gradients | {card}")
    print(f"[train-small] worst gradient error / bound (backbone: norm, "
          f"{BACKBONE_RTOL:g}; rest: max, {HEAD_RTOL:g}); {NOISE_STEPS} card steps, "
          f"default algorithms, each vs the next: {worst_by_part(noise)}; card "
          f"(deterministic) vs CPU: {worst_by_part(vs_cpu)} | {card}")
    assert_card_step_like_cpu("train-small", card_step, cpu_step, vs_cpu)
    assert not changed, f"the deterministic card step did not repeat: {changed}"


def phase_train_rot_small(table, card):
    """[train-small] with a MultiScan and an ARKitScenes scene (GT boxes
    with yaw): one fp32 step at full width on the CPU (plain versions) and
    one on the card (kernels, deterministic mode), held to [train-small]'s
    bounds. Then, from the same weights, the card's criterion alone under
    torch.cuda.set_sync_debug_mode("error"): the rotated branch reads
    nothing back from the card, and gives the step's loss."""
    cfg, batch, gt, pack, init, one = small_train(table, (2, ARKIT), 400)
    cpu_step = one("cpu")
    card_step = deterministic_card_step(one)
    vs_cpu = grad_ratios(card_step[2], cpu_step[2])

    model = UniDet3D(cfg, table, device="cuda")
    model.load_state_dict(init)
    b, p = to_device(batch, pack, "cuda")
    g = gt_to_device(gt, "cuda")
    out, aux = model(b, p, train=True, generator=torch.Generator().manual_seed(3))
    scene_gt = prepare_gt(cfg, b, g, aux)
    flags = scene_flags(cfg, b.dataset_ids)
    rotated = rotated_scenes_of(cfg, batch.dataset_ids)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss = criterion(out.cls_logits, out.boxes, aux.query_valid, scene_gt, *flags,
                         loss_weight=cfg.loss_weight, non_object_weight=cfg.non_object_weight,
                         rotated_scenes=rotated)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    loss = float(loss.detach())
    print(f"[train-rot-small] 2 scenes x {cfg.max_points} pts (datasets "
          f"{batch.dataset_ids.tolist()}, rotated {list(rotated)}), fp32, full width: loss "
          f"card {card_step[0]:.6f} CPU {cpu_step[0]:.6f}, grad_norm card {card_step[1]:.5f} "
          f"CPU {cpu_step[1]:.5f}; worst gradient error / bound, card (deterministic) vs "
          f"CPU: {worst_by_part(vs_cpu)} | {card}")
    print(f"[train-rot-small] the criterion under set_sync_debug_mode('error'): no "
          f"synchronising call, loss {loss:.6f} (default mode) | {card}")
    assert_card_step_like_cpu("train-rot-small", card_step, cpu_step, vs_cpu)
    assert abs(loss - card_step[0]) <= 1e-5 * abs(card_step[0]), (loss, card_step[0])


def phase_train(batch, gt, pack, pack_s, table, card, tag="train", steps=TRAIN_STEPS,
                split_reps=3):
    """The production training step at full width, bf16, on one collated
    8-scene batch: `steps` steps of make_train_step with the launches of
    each counted from zero, then split-timed steps and one profiled step.
    Every step draws the same queries (a generator seeded alike); [train]'s
    loss on the fixed batch must fall, every loss must be finite. With
    rotated scenes in the batch, the card time of the rotated matcher
    costs of one step is taken apart (CUDA events around rotated_costs on
    the first step's boxes)."""
    cfg = default_config()
    net = seeded_init_(UniDet3D(cfg, table, device="cuda"), 0)
    opt = make_optimizer(net.parameters())
    step = make_train_step(net, cfg, opt)
    host_ids = batch.dataset_ids
    rotated = rotated_scenes_of(cfg, host_ids)

    def gen():
        return torch.Generator().manual_seed(0)

    captured = {}
    hook = net.register_forward_hook(
        lambda mod, args, out: captured.__setitem__("out", out))
    torch.cuda.reset_peak_memory_stats()
    losses, norms, step_ms = [], [], []
    for i in range(steps):
        torch.cuda.synchronize()
        reset_counts()
        pools = pool_calls()
        t0 = time.perf_counter()
        b, p = to_device(batch, pack, "cuda")
        g = gt_to_device(gt, "cuda")
        metrics = step(b, g, p, gen(), host_dataset_ids=host_ids)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        launches = read_counts()
        assert launches == TRAIN_LAUNCHES, (tag, i, launches)
        pool_step = np.subtract(pool_calls(), pools).tolist()
        assert pool_step == [1, 1], (tag, i, pool_step)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        if i == 0:
            hook.remove()
            with torch.no_grad():
                out, aux = captured.pop("out")
                sgt = prepare_gt(cfg, b, g, aux)
                topk = torch.as_tensor(cfg.topk, device="cuda")[b.dataset_ids.long()]
                pairs = [match_scene(out.cls_logits[layer], out.boxes[layer], aux.query_valid,
                                     sgt, topk, rotated_scenes=rotated).pair_valid.sum((1, 2)).tolist()
                         for layer in (0, cfg.num_layers)]
                if rotated:  # every output set's costs of the rotated scenes
                    bq = torch.stack([out.boxes[:, j] for j in rotated], 1)
                    bg = torch.stack([sgt.boxes[j] for j in rotated])
                    rot_ms = cuda_ms(lambda: rotated_costs(bq, bg), reps=3)
            assert all(n > 0 for n in pairs[1]), pairs
            n_gt = gt.valid.sum(1).tolist()
            n_q = aux.query_valid.sum(1).tolist()
            print(f"[{tag}] {len(host_ids)} scenes x {SCENE_POINTS} pts (datasets "
                  f"{host_ids.tolist()}), voxels/level {list(pack.n_valid)}, "
                  f"valid queries {n_q}, GTs {n_gt}, matched pairs at step 1 "
                  f"(first / last output set) {pairs[0]} / {pairs[1]} | {card}")
            print(f"[{tag}] launches per step: " + ", ".join(
                f"{k} {v}" for k, v in launches.items()) + f" | {card}")
            if rotated:
                print(f"[{tag}] rotated matcher costs (scenes {list(rotated)}, "
                      f"{cfg.num_layers + 1} output sets x {aux.query_valid.shape[1]} queries x "
                      f"{cfg.max_gts} GTs each, chunks of 128 queries): {rot_ms:.2f} ms of card "
                      f"time per step (CUDA events, mean of 3) | {card}")
                phase_profile(lambda: (rotated_costs(bq, bg), torch.cuda.synchronize()),
                              card, f"the rotated matcher costs of one step ({tag})", top=6)
        print(f"[{tag}] step {i + 1}: loss {losses[-1]:.6f} grad_norm {norms[-1]:.5f} "
              f"step {step_ms[-1]:.1f} ms | {card}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    assert all(np.isfinite(losses)) and all(np.isfinite(norms)), (losses, norms)
    if tag == "train":
        assert losses[-1] < losses[0], f"loss did not fall: {losses}"

    h2d, fwd, bwd, optim = [], [], [], []
    for _ in range(split_reps):  # the step's body, synchronised between parts
        t0 = time.perf_counter()
        b, p = to_device(batch, pack, "cuda")
        g = gt_to_device(gt, "cuda")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out, aux = net(b, p, train=True, generator=gen())
        loss = detection_loss(cfg, out, aux, b, g, host_ids)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        opt.zero_grad()
        loss.backward()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        opt.step()
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        for acc, a, z in ((h2d, t0, t1), (fwd, t1, t2), (bwd, t2, t3), (optim, t3, t4)):
            acc.append((z - a) * 1e3)
    med = statistics.median
    warm = med(step_ms[1:])
    n = len(host_ids)
    print(f"[{tag}] host pack (native rulebooks) {pack_s:.2f} s for {n} scenes | {card}")
    print(f"[{tag}] warm median step {warm:.1f} ms over steps 2-{steps} "
          f"({n / (warm / 1e3):.2f} scenes/s), peak {peak:.1f} GiB | {card}")
    print(f"[{tag}] split (median of {split_reps} synchronised steps): H2D {med(h2d):.1f} ms, "
          f"forward+loss {med(fwd):.1f} ms, backward {med(bwd):.1f} ms, optimizer "
          f"{med(optim):.1f} ms | {card}")

    def run():
        b, p = to_device(batch, pack, "cuda")
        step(b, gt_to_device(gt, "cuda"), p, gen(), host_dataset_ids=host_ids)
        torch.cuda.synchronize()

    phase_profile(run, card, f"one training step ({tag})", top=16)
    return dict(launches, point_pool=sum(pool_step))

# [native-pack], [loader-train], [eval-loop] and [eval-loop-small].
LOADER_TRAIN_SCENES = {0: 8, 2: 4, ARKIT: 4}  # on disk: ScanNet, MultiScan, ARKitScenes
LOADER_TRAIN_STEPS = 8  # sustained over steps 3-8, the window of [train-cli]
SUSTAINED_FROM = 3  # [loader-train]'s sustained rate from step 3 on, waits included
# [loader-train]'s runs: TrainLoader's default workers (half the cores), then
# 2 and 8 (the JAX loader's default on an 8-core host) on the same batches.
LOADER_WORKERS = (None, 2, 8)
EVAL_SCANNET_POINTS = tuple(int(n) for n in np.linspace(48000, SCENE_POINTS, 12))
EVAL_ARKIT_SCENES = 8
EVAL_BATCH = 4
SMALL_EVAL_POINTS = (8192, 7000, 6000, 5000)  # [eval-loop-small]: 3RScan scenes
RSCAN = 3


def packs_equal(mine, ref) -> bool:
    """Every array of two GridPacks, every row, and n_valid."""
    return mine.n_valid == ref.n_valid and all(
        a.dtype == b.dtype and np.array_equal(a, b)
        for name in ("valid", "neighbors", "parent", "offset_code")
        for a, b in zip(getattr(mine, name), getattr(ref, name))
    ) and np.array_equal(mine.point_inverse, ref.point_inverse)


def phase_native_pack(groups, card):
    """The native rulebook builder against the numpy builder on collated
    groups ([(tag, samples)]): every table equal on every row, and each
    builder's seconds (native on one thread and on all cores), which it
    returns by tag."""
    cfg = default_config()
    cores = os.cpu_count()
    seconds = {}
    for tag, samples in groups:
        batch, _, _ = collate(samples, cfg, build_rulebooks=False)
        secs = {}
        for name, builder in (
                ("numpy", build_gridpack_numpy),
                ("native, 1 thread", functools.partial(build_gridpack_host, num_threads=1)),
                (f"native, {cores} threads",
                 functools.partial(build_gridpack_host, num_threads=cores))):
            t0 = time.perf_counter()
            pack = build_packs(batch.vox_src, batch.valid, cfg, builder)
            secs[name] = time.perf_counter() - t0
            if name == "numpy":
                ref = pack
            else:
                assert packs_equal(pack, ref), f"[native-pack] {tag}: {name} != numpy"
        print(f"[native-pack] {tag} ({len(samples)} scenes, voxels/level {list(ref.n_valid)}): "
              f"native tables equal to numpy's on every array, row and n_valid; seconds "
              + ", ".join(f"{k} {v:.3f}" for k, v in secs.items())
              + f" (os.cpu_count() {cores}) | {card}")
        seconds[tag] = secs
    return seconds


def info_scene(ds, name, n_points, seed):
    """One synthetic scene of dataset `ds` as its infos store it
    (data/synthetic.py::write_info_dataset): colors raw (ARKitScenes in
    [0, 1], the rest in [0, 255]), stripe superpoints, instances of
    SP_PER_GT stripes (N_GTS, fewer in a small scene) with their point
    bounds as boxes and raw labels: ScanNet's nyu40 ids in the semantic
    mask (so that its class mappings keep every instance), MultiScan's and
    3RScan's raw ids (their label mappings keep them), ARKitScenes' boxes
    with a yaw each."""
    rng = np.random.RandomState(seed)
    pts = synthetic_scene(n_points, seed=seed)
    sp = stripe_superpoints(pts, SP_SIZE)
    n_sp = int(sp.max()) + 1
    n_gts = min(N_GTS, n_sp // SP_PER_GT - 1)
    inst_of_sp = np.full(n_sp, -1)
    inst_of_sp[: n_gts * SP_PER_GT] = np.arange(n_gts * SP_PER_GT) // SP_PER_GT
    inst = inst_of_sp[sp]
    lo = np.stack([pts[inst == k, :3].min(0) for k in range(n_gts)])
    hi = np.stack([pts[inst == k, :3].max(0) for k in range(n_gts)])
    boxes = np.concatenate([(lo + hi) / 2, hi - lo], 1).astype(np.float32)
    labels = rng.randint(0, len(DATASETS_CLASSES[ds]), n_gts)
    raw = pts.copy()
    raw[:, 3:] = (pts[:, 3:] + 1) * (0.5 if ds == ARKIT else 127.5)
    scene = dict(name=name, points=raw, super_points=sp, boxes=boxes, labels=labels)
    if ds == 0:
        det_ids = np.asarray(SCANNET_DET_CAT_IDS)
        sem = np.where(inst >= 0, det_ids[labels[np.maximum(inst, 0)]],
                       rng.randint(1, 3, len(pts)))  # wall / floor
        scene.update(instance_mask=inst, semantic_mask=sem, axis_align_matrix=np.eye(4))
    elif ds in (2, RSCAN):
        raw_id = {i: c for c, i in DEFAULT_LABEL_MAPPINGS[cfg_name(ds)].items()}
        scene.update(instance_mask=inst, labels=np.asarray([raw_id[i] for i in labels]))
    else:
        yaw = rng.uniform(-np.pi, np.pi, (n_gts, 1)).astype(np.float32)
        scene.update(boxes=np.concatenate([boxes, yaw], 1))
    return scene


def cfg_name(ds) -> str:
    return default_config().datasets[ds]


def write_datasets(root, split, sizes: dict, seed0) -> dict:
    """{dataset index: data root} of on-disk datasets under `root`, each
    with the info file infos_<split>.pkl; sizes: {dataset index: [points
    per scene]}."""
    roots = {}
    for ds, points in sizes.items():
        name = cfg_name(ds)
        roots[ds] = os.path.join(root, name)
        write_info_dataset(roots[ds], [
            info_scene(ds, f"{split}{i:03d}", n, seed0 + 100 * ds + i)
            for i, n in enumerate(points)], ann_file=f"infos_{split}.pkl")
    return roots


def experiment(cfg, roots, split) -> ExperimentConfig:
    ann = {f"ann_{split}": f"infos_{split}.pkl"}
    return ExperimentConfig(
        model=cfg, batch_size=TRAIN_BATCH, eval_batch_size=EVAL_BATCH,
        datasets=tuple(DatasetSpec(cfg_name(ds), root, **ann)
                       for ds, root in roots.items()))


def tree_arrays(*trees) -> list:
    """Every array of PointBatch / GTBatch / GridPack trees, in order."""
    out = []
    for tree in trees:
        map_arrays(out.append, tree)
    return out


WORKER_PARTS = ("pipeline", "collate", "pack", "stage")


def worker_line(times) -> str:
    """Median and max seconds per batch of each worker part, then each
    worker's mean seconds per batch by part."""
    overall = ", ".join(
        f"{p} {statistics.median(getattr(t, p) for t in times):.3f} / "
        f"{max(getattr(t, p) for t in times):.3f}" for p in WORKER_PARTS)
    per_worker = []
    for thread in sorted({t.thread for t in times}):
        mine = [t for t in times if t.thread == thread]
        per_worker.append(f"{thread} ({len(mine)}) " + "/".join(
            f"{statistics.mean(getattr(t, p) for t in mine):.2f}" for p in WORKER_PARTS))
    return (f"{overall}; per worker (batches) mean s pipeline/collate/pack/stage: "
            + ", ".join(per_worker))


def loader_steps(exp, table, workers, check_staged):
    """LOADER_TRAIN_STEPS training steps fed by a TrainLoader of `workers`
    threads (None: its default) from fresh weights (seed 0), the launches
    of each step counted. Returns the run's numbers and its batches' host
    arrays; with check_staged, one staged batch is held bit for bit against
    a synchronous to_device of its arrays after its step."""
    cfg = exp.model
    net = seeded_init_(UniDet3D(cfg, table, device="cuda"), 0)
    step = make_train_step(net, cfg, make_optimizer(net.parameters()))
    loader = TrainLoader(ConcatDataset(build_datasets(exp, "train")), cfg, exp.batch_size,
                         seed=exp.seed, num_threads=workers)
    run = dict(waits=[], step_ms=[], losses=[], mix=[], hosts=[], staged=0,
               workers=len(loader._threads))
    try:
        for i in range(LOADER_TRAIN_STEPS):
            t0 = time.perf_counter()
            if i + 1 == SUSTAINED_FROM:
                t_sustained = t0
            tb = next(loader)
            t1 = time.perf_counter()
            reset_counts()
            metrics = step(tb.batch, tb.gt, tb.pack, torch.Generator().manual_seed(i),
                           host_dataset_ids=tb.host[0].dataset_ids)
            run["losses"].append(float(metrics["loss"]))
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            launches = read_counts()
            assert launches == TRAIN_LAUNCHES, ("loader-train", i, launches)
            run["waits"].append((t1 - t0) * 1e3)
            run["step_ms"].append((t2 - t1) * 1e3)
            run["mix"].append(tb.host[0].dataset_ids.tolist())
            run["hosts"].append(tb.host)
            if check_staged and i == LOADER_TRAIN_STEPS // 2:  # after its step
                b, p = to_device(tb.host[0], tb.host[2], "cuda")
                sync = tree_arrays(b, gt_to_device(tb.host[1], "cuda"), p)
                staged = tree_arrays(tb.batch, tb.gt, tb.pack)
                assert len(sync) == len(staged) and all(
                    torch.equal(x, y) for x, y in zip(staged, sync)), "staged != to_device"
                assert tb.pack.n_valid == tb.host[2].n_valid
                run["staged"] = len(staged)
        run["wall"] = time.perf_counter() - t_sustained
    finally:
        loader.close()
    assert all(np.isfinite(run["losses"])), run["losses"]
    run["times"], run["launches"] = list(loader.times), launches
    return run


def phase_loader_train(table, card, root):
    """The production training step fed by TrainLoader from on-disk
    datasets (ScanNet with elastic distortion, MultiScan, ARKitScenes;
    augmentation on), batch 8 at the full config, the batches staged on the
    card by the loader's workers: LOADER_TRAIN_STEPS steps with their
    launches counted, the consumer's wait in next(loader), the sustained
    rate from step SUSTAINED_FROM on (waits included), the workers' seconds
    per batch, and one staged batch held bit for bit against a synchronous
    to_device of its arrays; the same with each other count of workers in
    LOADER_WORKERS (the same batches: they depend on the seed alone). Then
    the same batches
    from the same weights without the loader: each step with a synchronous
    to_device and no worker threads running, which shows what the loader's
    threads cost the step and what the staged copy saved it."""
    sizes = {ds: [SCENE_POINTS] * n for ds, n in LOADER_TRAIN_SCENES.items()}
    exp = experiment(default_config(), write_datasets(root, "train", sizes, 0), "train")
    cfg = exp.model
    runs = [loader_steps(exp, table, workers, i == 0)
            for i, workers in enumerate(LOADER_WORKERS)]
    assert all(run["mix"] == runs[0]["mix"] for run in runs)
    net = seeded_init_(UniDet3D(cfg, table, device="cuda"), 0)
    step = make_train_step(net, cfg, make_optimizer(net.parameters()))
    replay_ms, replay_losses = [], []
    for i, (batch, gt, pack) in enumerate(runs[0]["hosts"]):  # no loader threads now
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b, p = to_device(batch, pack, "cuda")
        metrics = step(b, gt_to_device(gt, "cuda"), p, torch.Generator().manual_seed(i),
                       host_dataset_ids=batch.dataset_ids)
        replay_losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        replay_ms.append((time.perf_counter() - t0) * 1e3)
    for run in runs:
        del run["hosts"]
    n_sustained = LOADER_TRAIN_STEPS - SUSTAINED_FROM + 1
    print(f"[loader-train] {LOADER_TRAIN_STEPS} steps, batch {exp.batch_size} x {SCENE_POINTS} "
          f"pts from disk (ScanNet {LOADER_TRAIN_SCENES[0]}, MultiScan {LOADER_TRAIN_SCENES[2]}, "
          f"ARKitScenes {LOADER_TRAIN_SCENES[ARKIT]} scenes; augmentation on), datasets per "
          f"batch {runs[0]['mix']} | {card}")
    print(f"[loader-train] launches per step (every step): "
          + ", ".join(f"{k} {v}" for k, v in runs[0]["launches"].items()) + f" | {card}")
    for run in runs:
        tag = f"[loader-train] {run['workers']} workers (os.cpu_count() {os.cpu_count()}):"
        print(f"{tag} losses {[round(x, 4) for x in run['losses']]}; step ms (wait "
              f"excluded) {[round(x, 1) for x in run['step_ms']]}; wait ms "
              f"{[round(x, 1) for x in run['waits']]} | {card}")
        print(f"{tag} warm median step {statistics.median(run['step_ms'][1:]):.1f} ms over "
              f"steps 2-{LOADER_TRAIN_STEPS} (wait excluded); sustained "
              f"{n_sustained * exp.batch_size / run['wall']:.2f} scenes/s over steps "
              f"{SUSTAINED_FROM}-{LOADER_TRAIN_STEPS} (wall {run['wall']:.2f} s, waits "
              f"included); consumer wait in next(loader): first {run['waits'][0]:.1f} ms, "
              f"then median {statistics.median(run['waits'][1:]):.1f} ms, max "
              f"{max(run['waits'][1:]):.1f} ms | {card}")
        print(f"{tag} seconds per batch (median / max over {len(run['times'])} batches "
              f"built): {worker_line(run['times'])} | {card}")
    print(f"[loader-train] the same batches from the same weights without the loader "
          f"(synchronous to_device in the step, no worker threads): step ms "
          f"{[round(x, 1) for x in replay_ms]}, warm median "
          f"{statistics.median(replay_ms[1:]):.1f} ms, {n_sustained * exp.batch_size / sum(replay_ms[SUSTAINED_FROM - 1:]) * 1e3:.2f} "
          f"scenes/s over steps {SUSTAINED_FROM}-{LOADER_TRAIN_STEPS}; losses "
          f"{[round(x, 4) for x in replay_losses]} | {card}")
    print(f"[loader-train] staged batch {LOADER_TRAIN_STEPS // 2 + 1} equal bit for bit to "
          f"a synchronous to_device of its arrays ({runs[0]['staged']} tensors) | {card}")
    return runs[0]["workers"], n_sustained * exp.batch_size / runs[0]["wall"]


class LoopRecords(logging.Handler):
    """Collects the training loop's `train_stats` and evaluate's per-dataset
    `eval_stats` log records."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.train, self.eval = [], []
        self.train_at = []  # time.time() of each train_stats record

    def emit(self, record):
        if hasattr(record, "train_stats"):
            self.train.append(record.train_stats)
            self.train_at.append(record.created)
        if hasattr(record, "eval_stats"):
            self.eval.append(record.eval_stats)

    def of(self, kind) -> list:
        return [st for st in self.train if st["kind"] == kind]

    def at(self, stats) -> float:
        """The time.time() at which the loop logged `stats` (one of
        self.train)."""
        return next(t for st, t in zip(self.train, self.train_at) if st is stats)


@contextlib.contextmanager
def loop_records():
    """The port's logger at INFO with a LoopRecords attached."""
    logger = logging.getLogger("unidet3d_tpu_torch")
    handler, level = LoopRecords(), logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        yield handler
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)


def evaluate_with_stats(exp, model, device, **kw):
    """evaluate(), returning (results, [per-dataset eval_stats])."""
    with loop_records() as rec:
        res = evaluate(exp, model, device=device, logger=lambda *a: None, **kw)
    return res, rec.eval


def oracle_map(exp) -> dict:
    """Every validation scene's ground truth (through its dataset and test
    pipeline) fed to IndoorMetric as its detections: {dataset: results}."""
    metric = IndoorMetric(exp.model, exp.datasets_classes)
    for ds in build_datasets(exp, "val"):
        for i in range(len(ds)):
            sample = ds[i]
            boxes = np.zeros((len(sample["gt_bboxes_3d"]), 7), np.float32)
            boxes[:, :sample["gt_bboxes_3d"].shape[1]] = sample["gt_bboxes_3d"]
            labels = sample["gt_labels_3d"]
            metric.process(ds.dataset_idx, boxes, labels, np.ones(len(labels), np.float32),
                           np.ones(len(labels), bool), boxes, labels)
    return metric.compute(logger=None)


def assert_oracle(tag, exp, card):
    """The oracle gives AP 1.0 at 0.25 and 0.50 for each class with GT."""
    for name, res in oracle_map(exp).items():
        classes = exp.datasets_classes[exp.model.datasets.index(name)]
        with_gt = [c for c in classes if res.get(f"{c}_rec_0.25", 0) > 0]
        # AP integrates precision over recall in float64: 1 - 1e-16 is 1.
        assert with_gt and all(abs(res[f"{c}_AP_{t}"] - 1.0) <= 1e-9
                               for c in with_gt for t in ("0.25", "0.50")), (tag, name, res)
        print(f"[{tag}] oracle (each scene's ground truth as its detections) {name}: "
              f"AP@0.25 = AP@0.50 = 1.0 for all {len(with_gt)} classes with ground truth, "
              f"mAP_0.25 {res['mAP_0.25']:.6f} | {card}")


def map_line(res) -> str:
    return "; ".join(f"{name} mAP_0.25 {r['mAP_0.25']:.6f} mAP_0.50 {r['mAP_0.50']:.6f}"
                     for name, r in res.items())


def phase_eval_loop(table, card, root):
    """evaluate() at the full config on on-disk validation sets (ScanNet
    scenes of 48k-131k points, ARKitScenes through its test pipeline's
    100k-point cap), groups of EVAL_BATCH, random weights: per dataset
    scenes/s, ms per group, the buckets used and the workers' seconds; the
    launches (37 K1 and 6 K3 per group's forward); the mAP dict; the
    oracle."""
    sizes = {0: EVAL_SCANNET_POINTS, ARKIT: [SCENE_POINTS] * EVAL_ARKIT_SCENES}
    exp = experiment(default_config(), write_datasets(root, "val", sizes, 1000), "val")
    net = seeded_init_(UniDet3D(exp.model, table, device="cuda"), 0)
    torch.cuda.synchronize()
    reset_counts()
    res, stats = evaluate_with_stats(exp, net, "cuda")
    torch.cuda.synchronize()
    launches = read_counts()
    groups = sum(st["groups"] for st in stats)
    assert launches == dict(NO_LAUNCHES, subm_conv=37 * groups, flash_attention=6 * groups), \
        launches
    for st in stats:
        print(f"[eval-loop] {st['dataset']}: {st['scenes']} scenes in {st['groups']} groups of "
              f"{EVAL_BATCH}, {st['seconds']:.2f} s: {st['scenes'] / st['seconds']:.2f} scenes/s, "
              f"{st['seconds'] / st['groups'] * 1e3:.1f} ms per group ("
              f"{(st['seconds'] - st['wait_s'][0]) / st['groups'] * 1e3:.1f} after the "
              f"first group's wait); the loop's wait for "
              f"each group {[round(w * 1e3, 1) for w in st['wait_s']]} ms; groups per "
              f"(max_points, max_superpoints) bucket {st['buckets']}; workers' median s per "
              f"group " + ", ".join(f"{k} {v:.3f}" for k, v in st["worker_s"].items())
              + f" | {card}")
    scannet = stats[0]["buckets"]
    assert len({p for p, _ in scannet}) >= 2 and len({s for _, s in scannet}) >= 2, scannet
    print(f"[eval-loop] launches: K1 {launches['subm_conv']}, K3 {launches['flash_attention']} "
          f"over {groups} groups ({launches['subm_conv'] / groups:g} and "
          f"{launches['flash_attention'] / groups:g} per forward) | {card}")
    for name, r in res.items():
        assert all(np.isfinite(v) for v in r.values()), (name, r)
    print(f"[eval-loop] mAP (random weights: says nothing about accuracy): {map_line(res)} "
          f"| {card}")
    assert_oracle("eval-loop", exp, card)
    return exp, sum(st["seconds"] for st in stats)


class RecordingMetric(IndoorMetric):
    """IndoorMetric that also keeps each scene's whole detection arrays."""

    def __init__(self, *args):
        super().__init__(*args)
        self.scenes = []

    def process(self, dataset_idx, boxes, labels, scores, valid, gt_boxes, gt_labels):
        self.scenes.append((dataset_idx, boxes, labels, scores, valid))
        super().process(dataset_idx, boxes, labels, scores, valid, gt_boxes, gt_labels)


def phase_eval_small(table, card, root):
    """evaluate() at a small fp32 config (full width, 8,192 points, S = 512)
    on 4 small 3RScan scenes (no superpoint trimming, so the recorded boxes
    are NMS's own), on the card and on the CPU from the same weights, one
    loader thread (the test pipeline's subsampling draws from the dataset's
    RandomState): keep masks equal but for detections moved by order swaps
    of near-equal scores or with a same-class IoU within 1e-4 of iou_thr
    (as [map]), equal mAP dicts, and the oracle."""
    cfg = default_config(compute_dtype="float32", max_points=8192, voxel_capacity=8192,
                         max_superpoints=512)
    exp = experiment(cfg, write_datasets(root, "val", {RSCAN: SMALL_EVAL_POINTS}, 2000), "val")
    init = seeded_init_(UniDet3D(cfg, table, device="cpu"), 0).state_dict()
    runs = {}
    for device in ("cuda", "cpu"):
        net = UniDet3D(cfg, table, device=device)
        net.load_state_dict(init)
        metric = RecordingMetric(cfg, exp.datasets_classes)
        res, stats = evaluate_with_stats(exp, net, device, num_threads=1, metric=metric)
        runs[device] = (res, stats, metric.scenes)
    thr = cfg.iou_thr[RSCAN]
    differ = swapped = ambiguous = 0
    for card_scene, cpu_scene in zip(runs["cuda"][2], runs["cpu"][2]):
        _, boxes_c, labels_c, scores_c, keep_c = card_scene
        _, boxes, labels, scores, keep = cpu_scene
        moved = (labels_c != labels) | (np.abs(boxes_c - boxes) > 1e-4).any(-1)
        if moved.any():
            assert np.abs(scores_c - scores)[moved].max() <= 1e-5
        iou = pairwise_iou_aa(torch.from_numpy(boxes)).numpy()
        near = (np.abs(iou - thr) < 1e-4) & (labels[:, None] == labels[None, :])
        np.fill_diagonal(near, False)
        near = near.any(1)
        bad = (keep_c != keep) & ~moved & ~near
        assert not bad.any(), int(bad.sum())
        differ += int((keep_c != keep).sum())
        swapped += int(moved.sum())
        ambiguous += int(near.sum())
    res_card, res_cpu = runs["cuda"][0], runs["cpu"][0]
    assert res_card.keys() == res_cpu.keys()
    for name in res_cpu:
        for k, v in res_cpu[name].items():
            assert abs(res_card[name][k] - v) <= 1e-6, (name, k, res_card[name][k], v)
    st = runs["cuda"][1][0]
    print(f"[eval-loop-small] {len(SMALL_EVAL_POINTS)} 3RScan scenes of {SMALL_EVAL_POINTS} "
          f"pts, fp32, full width, S {cfg.max_superpoints}: buckets {st['buckets']}; keep "
          f"masks card vs CPU: {differ} of {len(runs['cpu'][2]) * cfg.topk_insts} differ, all "
          f"among the {swapped} moved by order swaps of near-equal scores and the "
          f"{ambiguous} with a same-class IoU within 1e-4 of iou_thr | {card}")
    print(f"[eval-loop-small] mAP card {map_line(res_card)}; CPU {map_line(res_cpu)}: equal "
          f"(random weights) | {card}")
    assert_oracle("eval-loop-small", exp, card)


# [train-cli], [test-cli], [resume] and [load-from]: the training loop, the
# CLIs and checkpoints at the full config on [loader-train]'s and
# [eval-loop]'s on-disk datasets.
CLI_STEPS = 4  # steps per epoch
CLI_EPOCHS = 2  # validation after epoch 2; [resume] adds epoch 3
CLI_CONFIG = """
from unidet3d_tpu_torch.core.config import default_config
from unidet3d_tpu_torch.core.experiment import DatasetSpec, ExperimentConfig


def get_config():
    return ExperimentConfig(
        model=default_config(), batch_size={batch}, epochs={epochs}, steps_per_epoch={steps},
        log_interval=2, ckpt_interval_epochs=1, ckpt_max_keep=1, val_interval_epochs={val_every},
        val_last_epochs=0, eval_batch_size={eval_batch}, seed=0, work_dir={work!r},
        datasets=(
            DatasetSpec("scannet", {scannet!r}, ann_train="infos_train.pkl",
                        ann_val="infos_val.pkl"),
            DatasetSpec("multiscan", {multiscan!r}, ann_train="infos_train.pkl"),
            DatasetSpec("arkitscenes", {arkit!r}, ann_train="infos_train.pkl",
                        ann_val="infos_val.pkl"),
        ))
"""
# The test CLI's mAP against the in-loop validation's, per key of the results:
# the eval forward's index_add_ sums are atomic on the card, so two runs'
# scores differ in their last bits and near-equal detections may swap ranks.
MAP_BOUND = 1e-3


def states_equal(a, b) -> bool:
    """Nested dicts / lists of tensors and numbers equal bit for bit."""
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b.to(a.device))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(states_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(states_equal(x, y) for x, y in zip(a, b))
    return a == b


def cli_launches(launches, steps, groups) -> dict:
    """The launches per training step once `groups` eval forwards (37 K1 and
    6 K3 each) are taken out; asserts they divide evenly."""
    per_step = {}
    for name, n in launches.items():
        n -= {"subm_conv": 37, "flash_attention": 6}.get(name, 0) * groups
        assert n % steps == 0, (name, launches[name], steps, groups)
        per_step[name] = n // steps
    return per_step


def sets_of(eval_stats) -> list:
    """(dataset, scenes, groups, buckets) of each evaluated dataset."""
    return [(st["dataset"], st["scenes"], st["groups"], st["buckets"]) for st in eval_stats]


def phase_train_cli(card, root, loader_sustained):
    """tools.train.main in this process on the card, with a config file this
    phase writes (the full config, batch 8, CLI_EPOCHS epochs of CLI_STEPS
    steps, a log line every 2 steps, a checkpoint every epoch keeping 1,
    validation after epoch 2) over [loader-train]'s training sets and
    [eval-loop]'s validation sets: launches per step (37/36/37/6/6/6, the
    validation's forwards taken out), finite losses, the loop's sustained
    scenes/s beside [loader-train]'s, seconds and bytes per checkpoint save,
    the validation's seconds. Returns what [test-cli] and [resume] need."""
    names = {0: "scannet", 2: "multiscan", ARKIT: "arkitscenes"}
    cfg_path = os.path.join(root, "train_cli_config.py")
    with open(cfg_path, "w") as f:
        f.write(CLI_CONFIG.format(batch=TRAIN_BATCH, epochs=CLI_EPOCHS, steps=CLI_STEPS,
                                  val_every=CLI_EPOCHS,
                                  eval_batch=EVAL_BATCH, work=os.path.join(root, "work"),
                                  **{("arkit" if ds == ARKIT else n): os.path.join(root, n)
                                     for ds, n in names.items()}))
    torch.cuda.synchronize()
    reset_counts()
    with loop_records() as rec:
        net, opt = train_cli.main([cfg_path])
    torch.cuda.synchronize()
    launches = read_counts()
    steps = CLI_EPOCHS * CLI_STEPS
    groups = sum(st["groups"] for st in rec.eval)
    per_step = cli_launches(launches, steps, groups)
    assert per_step == TRAIN_LAUNCHES, (per_step, launches, groups)
    assert opt.count == steps
    intervals = rec.of("interval")
    assert [st["step"] for st in intervals] == list(range(2, steps + 1, 2)), intervals
    assert all(np.isfinite(st["loss"]) for st in intervals), intervals
    later = intervals[1:]  # the first interval holds the loader's start
    sustained = sum(st["steps"] for st in later) * TRAIN_BATCH / sum(st["seconds"] for st in later)
    ckpts, (val,) = rec.of("checkpoint"), rec.of("val")
    print(f"[train-cli] tools.train.main: {CLI_EPOCHS} epochs x {CLI_STEPS} steps, batch "
          f"{TRAIN_BATCH} at the full config from [loader-train]'s on-disk sets, validation "
          f"after epoch {val['epoch']} on [eval-loop]'s ({groups} groups) | {card}")
    print(f"[train-cli] launches {launches}: per step (the validation's {groups} forwards "
          f"taken out) " + ", ".join(f"{k} {v}" for k, v in per_step.items()) + f" | {card}")
    print(f"[train-cli] losses at steps {[st['step'] for st in intervals]}: "
          f"{[round(st['loss'], 4) for st in intervals]} (ema {intervals[-1]['ema']:.4f}); "
          f"s per step by interval {[round(st['seconds'] / st['steps'], 3) for st in intervals]}"
          f"; epochs {[round(st['seconds'], 2) for st in rec.of('epoch')]} s | {card}")
    print(f"[train-cli] sustained {sustained:.2f} scenes/s over steps 3-{steps} (log intervals, "
          f"waits included) against [loader-train]'s {loader_sustained[1]:.2f} "
          f"({loader_sustained[0]} workers) | {card}")
    print(f"[train-cli] checkpoint saves: " + ", ".join(
        f"step {st['step']} {st['bytes']} bytes in {st['seconds']:.3f} s "
        f"({st['bytes'] / st['seconds'] / 1e9:.2f} GB/s)" for st in ckpts) + f" | {card}")
    print(f"[train-cli] validation after epoch {val['epoch']}: {val['seconds']:.2f} s; "
          f"{map_line(val['results'])} | {card}")
    return dict(cfg=cfg_path, net=net, opt=opt, val=val, val_sets=sets_of(rec.eval),
                ckpt_dir=os.path.join(root, "work", "checkpoints"))


def phase_test_cli(card, cli):
    """tools.test.main on [train-cli]'s checkpoint (step 8): the same
    datasets, scenes, groups and buckets as the in-loop validation, and its
    results against the validation's, every key within MAP_BOUND."""
    torch.cuda.synchronize()
    reset_counts()
    with loop_records() as rec:
        res = test_cli.main([cli["cfg"], cli["ckpt_dir"], "--step", str(CLI_EPOCHS * CLI_STEPS)])
    torch.cuda.synchronize()
    launches = read_counts()
    groups = sum(st["groups"] for st in rec.eval)
    assert launches == dict(NO_LAUNCHES, subm_conv=37 * groups, flash_attention=6 * groups), \
        launches
    assert sets_of(rec.eval) == cli["val_sets"], (sets_of(rec.eval), cli["val_sets"])
    ref = cli["val"]["results"]
    assert res.keys() == ref.keys() and all(r.keys() == ref[n].keys() for n, r in res.items())
    worst = max(abs(r[k] - ref[n][k]) for n, r in res.items() for k in r)
    assert worst <= MAP_BOUND, (worst, res, ref)
    print(f"[test-cli] tools.test.main on step {CLI_EPOCHS * CLI_STEPS}: {map_line(res)}; "
          f"in-loop validation {map_line(ref)}; largest difference over "
          f"{sum(len(r) for r in res.values())} result keys {worst:.3g} (bound {MAP_BOUND}: "
          f"atomic index_add_ in the eval forward); launches K1 {launches['subm_conv']}, K3 "
          f"{launches['flash_attention']} over {groups} groups | {card}")


def phase_resume(card, cli):
    """[train-cli]'s kept checkpoint (step 8, the only one kept) equal bit
    for bit to the model and optimizer train() returned; restored into a
    fresh model and optimizer (epochs 3) bit for bit, count 8 and the next lr
    the schedule's at 8; then tools.train.main --resume auto with epochs 3:
    it starts at step 8, trains epoch 3 only (launches per step) and keeps
    step 12."""
    steps = CLI_EPOCHS * CLI_STEPS
    mngr = CheckpointManager(cli["ckpt_dir"])
    assert mngr.all_steps() == [steps], mngr.all_steps()
    size = os.path.getsize(mngr.path(steps))
    ckpt = torch.load(mngr.path(steps), map_location="cuda", weights_only=True)
    assert ckpt["step"] == steps
    assert states_equal(ckpt["model"], cli["net"].state_dict())
    assert states_equal(ckpt["optimizer"], cli["opt"].state_dict())
    exp = apply_overrides(load_experiment(cli["cfg"]), [f"epochs={CLI_EPOCHS + 1}"])
    net, _ = build_model(exp)
    total = exp.epochs * exp.steps_per_epoch
    opt = make_optimizer(net.parameters(), base_lr=exp.lr, weight_decay=exp.weight_decay,
                         total_steps=total, power=exp.lr_power, clip_norm=exp.clip_norm)
    t0 = time.perf_counter()
    assert mngr.restore(net, opt) == steps
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    assert states_equal(net.state_dict(), cli["net"].state_dict())
    assert states_equal(opt.state_dict(), cli["opt"].state_dict())
    next_lr = exp.lr * (1 - steps / total) ** exp.lr_power
    assert opt.count == steps and opt.schedule(opt.count) == next_lr
    del net, opt, ckpt
    torch.cuda.synchronize()
    reset_counts()
    with loop_records() as rec:
        _, opt = train_cli.main([cli["cfg"], "--resume", "auto", "--cfg-options",
                                 f"epochs={CLI_EPOCHS + 1}"])
    torch.cuda.synchronize()
    launches = read_counts()
    assert rec.of("resume") == [dict(kind="resume", step=steps)], rec.of("resume")
    intervals = rec.of("interval")
    assert [(st["epoch"], st["step"]) for st in intervals] == [
        (CLI_EPOCHS + 1, steps + 2), (CLI_EPOCHS + 1, steps + 4)], intervals
    assert intervals[0]["lr"] == exp.lr * (1 - (steps + 1) / total) ** exp.lr_power
    assert all(np.isfinite(st["loss"]) for st in intervals)
    per_step = cli_launches(launches, CLI_STEPS, 0)
    assert per_step == TRAIN_LAUNCHES and opt.count == steps + CLI_STEPS, (per_step, opt.count)
    assert mngr.all_steps() == [steps + CLI_STEPS]
    print(f"[resume] checkpoint of step {steps} ({size} bytes) equal bit for bit to the model and optimizer train() returned; restored "
          f"into a fresh model and optimizer in {restore_s:.3f} s, bit for bit, count {steps}, "
          f"next lr {next_lr:.6e} = the schedule's at {steps} of {total} | {card}")
    print(f"[resume] --resume auto, epochs {CLI_EPOCHS + 1}: resumed from step {steps}, "
          f"epoch {CLI_EPOCHS + 1} only (steps {[st['step'] for st in intervals]}, losses "
          f"{[round(st['loss'], 4) for st in intervals]}, lr {intervals[0]['lr']:.6e} at step "
          f"{steps + 2}), count {opt.count}, kept {mngr.all_steps()}; launches per step "
          + ", ".join(f"{k} {v}" for k, v in per_step.items()) + f" | {card}")


def phase_load_from(card, root, cli, table):
    """A synthetic reference-format unidet3d.pth at the production widths
    through tools.convert_checkpoint.main, then tools.train.main with
    load_from (prefix backbone) and no epochs, so that what it returns is the
    initialised model: every backbone.* tensor (parameters and running
    statistics) equal to the converted one, every decoder.* tensor to the
    seeded init."""
    cfg = default_config()
    src, dst = os.path.join(root, "unidet3d.pth"), os.path.join(root, "converted.pth")
    torch.save({"state_dict": reference_state_dict(cfg.num_planes, cfg.d_model, cfg.num_layers,
                                                   len(table.unified_classes))}, src)
    t0 = time.perf_counter()
    converted = convert_checkpoint.main(
        [src, dst, "--planes", *map(str, cfg.num_planes), "--d-model", str(cfg.d_model),
         "--heads", str(cfg.num_heads), "--layers", str(cfg.num_layers)])
    convert_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    reset_counts()
    with loop_records():
        net, _ = train_cli.main([cli["cfg"], "--work-dir", os.path.join(root, "work_load"),
                                 "--cfg-options", "epochs=0", f"load_from={dst}"])
    torch.cuda.synchronize()
    launches = read_counts()
    assert launches == NO_LAUNCHES, launches
    init = seeded_init_(UniDet3D(cfg, table, device="cpu"), 0).state_dict()
    got = {k: v.cpu() for k, v in net.state_dict().items()}
    backbone = [k for k in got if k.startswith("backbone.")]
    decoder = [k for k in got if k.startswith("decoder.")]
    assert len(backbone) + len(decoder) == len(got)
    assert all(torch.equal(got[k], converted[k]) for k in backbone)
    assert all(torch.equal(got[k], init[k]) for k in decoder)
    n_stats = sum(k.endswith(("running_mean", "running_var")) for k in backbone)
    print(f"[load-from] tools.convert_checkpoint.main on a synthetic reference unidet3d.pth at "
          f"the production widths: {len(converted)} tensors in {convert_s:.2f} s; "
          f"tools.train.main with load_from: all {len(backbone)} backbone.* tensors (of them "
          f"{n_stats} running statistics) equal to the converted ones, all {len(decoder)} "
          f"decoder.* tensors equal to seeded_init_(seed 0); no kernel launched | {card}")



# [show-dir], [record-activations], [parity-eval] and [prep]: the
# visualisation, checkpoint-parity and data-preparation tools, on the card
# where they run a forward, in the temporary data root of the phases above.
# [show-dir]'s CPU run: a narrow, small-capacity model. The points and ground
# truth that evaluate() draws are the datasets' and test pipelines' alone
# (collate subsamples its own copy), so they must equal the card's byte for
# byte whatever the model; the full config on the CPU would take minutes.
SHOW_CPU_MODEL = dict(num_planes=(8, 16), d_model=32, num_heads=2, hidden_dim=32,
                      num_layers=1, max_points=16384, voxel_capacity=16384,
                      max_superpoints=512, compute_dtype="float32")
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures",
                       "activations_seed0.npz")
# The recorder's fixture config in fp32: the card against the CPU within
# [e2e-small]'s bound (1e-3 of each probe's largest magnitude, at least 1).
RECORD_FP32_CONFIG = """
from unidet3d_tpu_torch.core.config import default_config
from unidet3d_tpu_torch.core.experiment import DatasetSpec, ExperimentConfig


def get_config():
    return ExperimentConfig(
        model=default_config(max_points=4096, voxel_capacity=4096, max_superpoints=512,
                             compute_dtype="float32"),
        datasets=(DatasetSpec(name="scannet", data_root="."),))
"""
PARITY_POINTS = (96000, 80000, 64000, 48000)  # [parity-eval]: one group of ScanNet scenes
PARITY_CONFIG = """
from unidet3d_tpu_torch.core.config import default_config
from unidet3d_tpu_torch.core.experiment import DatasetSpec, ExperimentConfig


def get_config():
    return ExperimentConfig(
        model=default_config(), eval_batch_size={eval_batch},
        datasets=(DatasetSpec("scannet", {root!r}, ann_val="infos_val.pkl"),))
"""
PREP_SIDE = 317  # [prep]'s mesh: a 317 x 317 vertex grid, 100,489 vertices
PREP_GENERIC_POINTS = (100000, 90000)  # two scenes through create_data's generic path


def captured(fn, *args):
    """fn(*args) with its standard output caught: (result, the text)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn(*args)
    return result, buf.getvalue()


def scene_order(ds) -> list:
    """The eval loader's order of `ds`'s scenes (one process): largest first."""
    sizes = np.asarray([ds.scene_size(k) for k in range(len(ds))])
    return np.argsort(-sizes, kind="stable").tolist()


def read_bytes(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def phase_show_dir(exp, eval_s, table, card, root):
    """[show-dir]: evaluate() on the card with show_dir over [eval-loop]'s
    validation sets and weights, one loader thread (ARKitScenes' test
    pipeline draws from its dataset's RandomState in the loader's order):
    one directory per real scene, named <dataset>_scene<k> by its index in
    its info file, none twice; each _pred.obj with as many boxes as the
    card's keep mask of that scene; 37 K1 and 6 K3 per forward. Then
    evaluate() on the CPU over the same scenes (SHOW_CPU_MODEL): every
    _points.obj and _gt.obj equal to the card's byte for byte."""
    out = os.path.join(root, "show_card")
    net = seeded_init_(UniDet3D(exp.model, table, device="cuda"), 0)
    metric = RecordingMetric(exp.model, exp.datasets_classes)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    _, stats = evaluate_with_stats(exp, net, "cuda", num_threads=1, metric=metric,
                                   show_dir=out)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launches = read_counts()
    groups = sum(st["groups"] for st in stats)
    assert launches == dict(NO_LAUNCHES, subm_conv=37 * groups, flash_attention=6 * groups), \
        launches
    datasets = build_datasets(exp, "val")
    names = [f"{exp.model.datasets[ds.dataset_idx]}_scene{k:05d}"
             for ds in datasets for k in range(len(ds))]
    assert sorted(os.listdir(out)) == sorted(names) and len(set(names)) == len(names)
    # The metric saw the scenes in the loader's order; each scene's keep mask
    # against the boxes in its _pred.obj (8 vertices and 12 lines per box).
    seen = iter(metric.scenes)
    kept = []
    for ds in datasets:
        for k in scene_order(ds):
            didx, _, _, _, keep = next(seen)
            assert didx == ds.dataset_idx
            name = f"{exp.model.datasets[didx]}_scene{k:05d}"
            n = int(np.asarray(keep, bool).sum())
            pred = os.path.join(out, name, f"{name}_pred.obj")
            if n:
                kinds = [ln[:2] for ln in read_bytes(pred).decode().splitlines()]
                assert (kinds.count("v "), kinds.count("l ")) == (8 * n, 12 * n), (name, n)
            else:
                assert not os.path.exists(pred), name
            kept.append(n)
    assert next(seen, None) is None and sum(kept) > 0
    n_points = sum(read_bytes(os.path.join(out, n, f"{n}_points.obj")).count(b"\n")
                   for n in names)
    print(f"[show-dir] evaluate() on the card with show_dir over [eval-loop]'s sets: "
          f"{len(names)} scene directories named by info index, none twice "
          f"({names[0]} ... {names[-1]}); kept boxes per _pred.obj {kept} = the card's keep "
          f"masks; launches K1 {launches['subm_conv']}, K3 {launches['flash_attention']} over "
          f"{groups} groups (37 / 6 per forward); {card_s:.2f} s with the .obj files "
          f"({n_points} points written) against [eval-loop]'s {eval_s:.2f} s without | {card}")

    cpu_cfg = default_config(**SHOW_CPU_MODEL)
    cpu_exp = dataclasses.replace(exp, model=cpu_cfg)
    cpu_net = seeded_init_(UniDet3D(cpu_cfg, table, device="cpu"), 0)
    cpu_out = os.path.join(root, "show_cpu")
    t0 = time.perf_counter()
    evaluate_with_stats(cpu_exp, cpu_net, "cpu", num_threads=1, show_dir=cpu_out)
    cpu_s = time.perf_counter() - t0
    assert sorted(os.listdir(cpu_out)) == sorted(names)
    n_files = 0
    for name in names:
        for tag in ("points", "gt"):
            f = f"{name}_{tag}.obj"
            assert read_bytes(os.path.join(out, name, f)) == read_bytes(
                os.path.join(cpu_out, name, f)), f
            n_files += 1
    print(f"[show-dir] evaluate() on the CPU over the same scenes (a narrow model at "
          f"max_points {cpu_cfg.max_points}): all {n_files} _points.obj / _gt.obj files equal "
          f"to the card's byte for byte; {cpu_s:.2f} s | {card}")


def phase_record_activations(card, root):
    """[record-activations]: tools.record_activations.main on the card, the
    weights seeded_init_(0), the 4,096-point fixture scene: the fixture's
    seven probe names, shapes and dtypes, 37 K1 and 6 K3 launches; then
    the fixture config in fp32 on the card against the same recorder on the
    CPU, each probe within [e2e-small]'s bound over valid rows (the
    superpoint mask and the unused class columns equal); the default (bf16)
    card run's differences from the CPU are printed beside them."""
    fixture = np.load(FIXTURE)
    cfg32 = os.path.join(root, "record_fp32.py")
    with open(cfg32, "w") as f:
        f.write(RECORD_FP32_CONFIG)
    runs = {}
    for tag, extra in (("bf16", []), ("fp32", ["--config", cfg32])):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        rec, text = captured(record_tool.main,
                             [os.path.join(root, f"rec_{tag}_card.npz"), *extra])
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        launches = read_counts()
        assert launches == dict(NO_LAUNCHES, subm_conv=37, flash_attention=6), (tag, launches)
        ref, _ = captured(record_tool.main,
                          [os.path.join(root, f"rec_{tag}_cpu.npz"), *extra, "--device", "cpu"])
        assert set(rec) == set(ref) == set(fixture.files), (tag, sorted(rec))
        for name in fixture.files:
            assert rec[name].shape == fixture[name].shape, (tag, name, rec[name].shape)
            assert rec[name].dtype == fixture[name].dtype, (tag, name, rec[name].dtype)
        valid = ref["aux/sp_valid"][0]
        assert np.array_equal(rec["aux/sp_valid"], ref["aux/sp_valid"]), tag
        rows = {"inter/backbone/__call__/0": lambda x: x,
                "aux/sp_centers": lambda x: x[0, valid]}
        errs = {}
        for name in fixture.files:
            if name == "aux/sp_valid":
                continue
            pick = rows.get(name, lambda x: x[:, 0, valid])
            a, b = pick(rec[name]), pick(ref[name])
            # The class columns a dataset does not use hold NEG_INF on both
            # sides; the scale is the real columns'.
            masked = b <= NEG_INF
            assert np.array_equal(a[masked], b[masked]), (tag, name)
            a, b = a[~masked], b[~masked]
            scale = max(1.0, float(np.abs(b).max()))
            errs[name] = (float(np.abs(a - b).max()), scale)
            if tag == "fp32":
                assert errs[name][0] <= 1e-3 * scale, (name, errs[name])
        runs[tag] = (errs, card_s, text.strip())
    for tag, (errs, card_s, text) in runs.items():
        print(f"[record-activations] {tag} ({'the tool default' if tag == 'bf16' else 'asserted'}"
              f"): the fixture's 7 probe names, shapes and dtypes; 37 K1 and 6 K3 launches; "
              f"card vs CPU max abs err / largest magnitude over valid rows: " + ", ".join(
                  f"{n.split('/', 1)[1]} {e:.2e} / {sc:.3g}" for n, (e, sc) in errs.items())
              + f"; the card call {card_s:.2f} s ({text}) | {card}")


def phase_parity_eval(card, root):
    """[parity-eval]: tools.parity_eval.main on [load-from]'s synthetic
    reference unidet3d.pth (production widths) at the full config, over a
    ScanNet validation set whose infos exist only in mmdet3d-v2 form under
    mmdet3d/ (so the re-anchor path runs): it prints the delta table and
    returns 1 at the default tolerance (random weights), then 0 at a
    tolerance above 100; 37 K1 and 6 K3 per group's forward."""
    data = os.path.join(root, "parity_scannet")
    path = write_info_dataset(data, [info_scene(0, f"scene{i:04d}_00", n, 3000 + i)
                                     for i, n in enumerate(PARITY_POINTS)], ann_file="port.pkl")
    with open(path, "rb") as f:
        info = pickle.load(f)
    os.remove(path)
    for e in info["data_list"]:  # bare file names, as mmdet3d writes them
        e["lidar_points"]["lidar_path"] = os.path.basename(e["lidar_points"]["lidar_path"])
        for key in ("pts_semantic_mask_path", "pts_instance_mask_path", "super_pts_path"):
            e[key] = os.path.basename(e[key])
    os.makedirs(os.path.join(data, "mmdet3d"))
    with open(os.path.join(data, "mmdet3d", "infos_val.pkl"), "wb") as f:
        pickle.dump(info, f)
    cfg_path = os.path.join(root, "parity_config.py")
    with open(cfg_path, "w") as f:
        f.write(PARITY_CONFIG.format(eval_batch=EVAL_BATCH, root=data))
    ckpt = os.path.join(root, "unidet3d.pth")
    ann = os.path.join(data, "infos_val.pkl")
    assert os.path.exists(ckpt) and not os.path.exists(ann)
    out = {}
    for tol in ("0.3", "101"):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        with loop_records() as rec:
            code, text = captured(parity_eval.main, [ckpt, "--config", cfg_path, "--tolerance",
                                                     tol])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = read_counts()
        groups = sum(st["groups"] for st in rec.eval)
        assert groups >= 1 and launches == dict(
            NO_LAUNCHES, subm_conv=37 * groups, flash_attention=6 * groups), launches
        out[tol] = (code, text, secs, groups)
        if tol == "0.3":
            assert os.path.exists(ann), "the mmdet3d-v2 infos were not re-anchored"
    code, text, secs, groups = out["0.3"]
    lines = text.splitlines()
    header = next(i for i, ln in enumerate(lines) if ln.startswith("dataset "))
    row = lines[header + 1]
    assert code == 1 and row.split()[0] == "scannet", (code, lines)
    assert "PARITY FAIL (|delta| > 0.3): ['scannet']" in text, text
    code_ok, text_ok, secs_ok, _ = out["101"]
    assert code_ok == 0 and row in text_ok.splitlines(), text_ok
    assert "PARITY OK (all deltas within 101.0)" in text_ok, text_ok
    for ln in lines[header:header + 2]:
        print(f"[parity-eval] {ln} | {card}")
    print(f"[parity-eval] tools.parity_eval.main on the synthetic reference unidet3d.pth: "
          f"re-anchored mmdet3d/infos_val.pkl ({len(PARITY_POINTS)} ScanNet scenes), converted "
          f"and evaluated in {secs:.2f} s (K1 37, K3 6 per forward over {groups} group); exit "
          f"1 at --tolerance 0.3 (random weights), 0 at 101 ({secs_ok:.2f} s) | {card}")


def phase_prep(table, card, root):
    """[prep]: the native segmentator built with g++ on this machine and run
    on a synthetic 100,489-vertex mesh; two scenes exported through
    create_data's generic path (as 3RScan) and one through
    prepare_multiscan (its superpoints from the segmentator); each read back
    through IndoorDataset, then one evaluate() group of each dataset on the
    card at the full config (37 K1 and 6 K3 per forward, finite mAP)."""
    fresh = not segmentator.library_path().exists()
    t0 = time.perf_counter()
    lib = segmentator.build()
    build_s = time.perf_counter() - t0
    rng = np.random.RandomState(0)
    xs, ys = np.meshgrid(np.arange(PREP_SIDE), np.arange(PREP_SIDE))
    verts = np.stack([xs.ravel() * 0.02, ys.ravel() * 0.02,
                      np.where(xs.ravel() < PREP_SIDE // 2, 0.0, (xs.ravel() - PREP_SIDE // 2) * 0.02)
                      + rng.rand(xs.size) * 0.002], 1).astype(np.float32)
    a = (np.arange(PREP_SIDE - 1)[:, None] * PREP_SIDE + np.arange(PREP_SIDE - 1)[None]).ravel()
    faces = np.concatenate([np.stack([a, a + 1, a + PREP_SIDE], 1),
                            np.stack([a + 1, a + PREP_SIDE + 1, a + PREP_SIDE], 1)]).astype(np.int32)
    t0 = time.perf_counter()
    seg = segmentator.segment_mesh(verts, faces)
    seg_s = time.perf_counter() - t0
    assert seg.shape == (len(verts),) and seg.min() == 0 and seg.max() >= 1
    assert np.array_equal(np.unique(seg), np.arange(seg.max() + 1))

    # create_data's generic path: <scene>_point.npy and its labels, as 3RScan.
    raw = os.path.join(root, "prep_raw")
    os.makedirs(raw)
    names = []
    for i, n in enumerate(PREP_GENERIC_POINTS):
        scene = info_scene(RSCAN, f"gen{i}", n, 4000 + i)
        name = scene["name"]
        np.save(os.path.join(raw, f"{name}_point.npy"), scene["points"])
        np.save(os.path.join(raw, f"{name}_ins_label.npy"), scene["instance_mask"])
        np.save(os.path.join(raw, f"{name}_sem_label.npy"), np.zeros(n, np.int64))
        np.save(os.path.join(raw, f"{name}_sp.npy"), scene["super_points"])
        np.save(os.path.join(raw, f"{name}_bbox.npy"), np.concatenate(
            [scene["boxes"], scene["labels"][:, None]], 1).astype(np.float32))
        names.append(name)
    gen_root = os.path.join(root, "prep_3rscan")
    t0 = time.perf_counter()
    create_data.prepare_generic(raw, gen_root, names, "infos_val.pkl", workers=2)
    gen_s = (time.perf_counter() - t0) / len(names)

    # prepare_multiscan: one .pth scene on the mesh, 20 instances of 1/25 of it.
    pth_dir = os.path.join(root, "prep_pths")
    os.makedirs(pth_dir)
    inst = np.arange(len(verts)) // (len(verts) // 25)
    inst[inst >= 20] = -1
    sem = np.where(inst >= 0, 3 + inst % 17, 2)
    torch.save({"xyz": verts, "rgb": (rng.rand(len(verts), 3) * 255).astype(np.float32),
                "faces": faces, "instance_ids": inst, "sem_labels": sem, "inst2obj": {}},
               os.path.join(pth_dir, "scene_ms0.pth"))
    ms_root = os.path.join(root, "prep_multiscan")
    t0 = time.perf_counter()
    prep_datasets.prepare_multiscan(pth_dir, ms_root, "infos_val.pkl", workers=1)
    ms_s = time.perf_counter() - t0

    back = {}
    for name, data_root, ds in (("3rscan", gen_root, RSCAN), ("multiscan", ms_root, 2)):
        d = IndoorDataset(data_root, "infos_val.pkl", ds, test_mode=True,
                          label_mapping=DEFAULT_LABEL_MAPPINGS[name])
        back[name] = [(len(d[k]["points"]), len(d[k]["gt_labels_3d"]),
                       int(d[k]["sp_pts_mask"].max()) + 1) for k in range(len(d))]
    assert [n for n, _, _ in back["3rscan"]] == list(PREP_GENERIC_POINTS), back
    assert back["multiscan"] == [(len(verts), 20, int(seg.max()) + 1)], back
    exp = ExperimentConfig(model=default_config(), eval_batch_size=EVAL_BATCH, datasets=(
        DatasetSpec("3rscan", gen_root, ann_val="infos_val.pkl"),
        DatasetSpec("multiscan", ms_root, ann_val="infos_val.pkl")))
    net = seeded_init_(UniDet3D(exp.model, table, device="cuda"), 0)
    torch.cuda.synchronize()
    reset_counts()
    res, stats = evaluate_with_stats(exp, net, "cuda")
    torch.cuda.synchronize()
    launches = read_counts()
    assert [st["groups"] for st in stats] == [1, 1], stats
    assert launches == dict(NO_LAUNCHES, subm_conv=37 * 2, flash_attention=6 * 2), launches
    for name, r in res.items():
        assert all(np.isfinite(v) for v in r.values()), (name, r)
    print(f"[prep] native segmentator: g++ build {build_s:.2f} s "
          f"({lib.name}{'' if fresh else ', already built'}); "
          f"{len(verts)} vertices, {len(faces)} faces -> {int(seg.max()) + 1} segments in "
          f"{seg_s:.3f} s ({seg_s / (len(verts) / 1e5):.3f} s per 100k vertices) | {card}")
    print(f"[prep] create_data generic export: {len(names)} scenes of {PREP_GENERIC_POINTS} "
          f"points, {gen_s:.3f} s per scene; prepare_multiscan (segmentator included): 1 scene "
          f"of {len(verts)} points in {ms_s:.3f} s; read back through IndoorDataset (points, "
          f"boxes, superpoints) {back} | {card}")
    print(f"[prep] evaluate() on the card, one group of each: launches K1 "
          f"{launches['subm_conv']}, K3 {launches['flash_attention']} (37 / 6 per forward); "
          f"{map_line(res)} (random weights) | {card}")


# [device-pack] and [ddp].
DDP_WORLD = 2  # ranks on the one card, over gloo (NCCL refuses two ranks per card)
DDP_CHECKED_STEPS = 2  # deterministic steps: the first against one process, then params
DDP_TIMED_STEPS = 2  # default-mode steps, timed
DDP_CLI_STEPS = 2  # tools.train.main: 1 epoch of 2 steps, then validation
DDP_TIMEOUT_S = 600
# The DDP step against the one-process step, in units of the card's own
# run-to-run noise: the worst difference between successive default-mode
# one-process steps from the same state, over DDP_NOISE_STEPS of them.
DDP_NOISE_FACTOR = 3.0
DDP_NOISE_STEPS = 3


def phase_device_pack(samples, table, card, native_s):
    """[device-pack]: build_gridpack_device on [prod]'s 4-scene group, from
    the batch staged on the card: every table, row and n_valid equal to the
    native builder's, and the builder's ms (CUDA events, its one host read
    included) beside [native-pack]'s seconds; then, in PyTorch's
    deterministic mode, the forward without a pack (37 K1 and 6 K3
    launches, counted) equal bit for bit to the forward on the native pack."""
    cfg = default_config()
    batch, _, pack_np = collate(samples, cfg)
    b, p = to_device(batch, pack_np, "cuda")
    caps = cfg.level_capacities(len(samples))

    def build():
        return build_gridpack_device(quantize_points_device(b.vox_src, b.valid),
                                     b.valid.reshape(-1), caps)

    pack, _ = build()
    assert packs_equal(map_arrays(lambda x: x.cpu().numpy(), pack), pack_np), \
        "[device-pack] device tables != native tables"
    build_ms = cuda_ms(build, reps=5)
    net = seeded_init_(UniDet3D(cfg, table, device="cuda"), 0)
    torch.use_deterministic_algorithms(True)
    try:
        with torch.no_grad():
            torch.cuda.synchronize()
            reset_counts()
            out_d, aux_d = net(b, None)
            torch.cuda.synchronize()
            launches = read_counts()
            out_h, aux_h = net(b, p)
    finally:
        torch.use_deterministic_algorithms(False)
    assert launches == dict(NO_LAUNCHES, subm_conv=37, flash_attention=6), launches
    differ = [name for name, x, y in zip((*out_d._fields, *aux_d._fields),
                                         (*out_d, *aux_d), (*out_h, *aux_h))
              if not torch.equal(x, y)]
    assert not differ, f"[device-pack] pack=None forward != native-pack forward: {differ}"
    print(f"[device-pack] build_gridpack_device on [prod]'s {len(samples)} scenes (voxels/level "
          f"{list(pack.n_valid)}): every table, row and n_valid equal to the native builder's; "
          f"{build_ms:.2f} ms per build (CUDA events, mean of 5, its one host read included) "
          f"against [native-pack]'s " + ", ".join(f"{k} {v:.3f} s" for k, v in native_s.items())
          + f" | {card}")
    print(f"[device-pack] forward(batch, None), deterministic mode: launches K1 "
          f"{launches['subm_conv']}, K3 {launches['flash_attention']}; outputs and aux equal "
          f"bit for bit to the forward on the native pack | {card}")


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def one_process_step(batch, gt, pack, table, deterministic):
    """[train]'s first step on the whole batch from seeded_init_(0), queries
    from a CPU generator seeded 0: loss, grad_norm, gradients and running
    statistics on the host."""
    cfg = default_config()
    net = seeded_init_(UniDet3D(cfg, table, device="cuda"), 0)
    step = make_train_step(net, cfg, make_optimizer(net.parameters()))
    b, p = to_device(batch, pack, "cuda")
    g = gt_to_device(gt, "cuda")
    torch.use_deterministic_algorithms(deterministic)
    try:
        m = step(b, g, p, torch.Generator().manual_seed(0), host_dataset_ids=batch.dataset_ids)
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    return dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                grads={n: x.grad.to("cpu", copy=True) for n, x in net.named_parameters()},
                stats={k: v.to("cpu", copy=True) for k, v in net.state_dict().items() if "running" in k})


def stats_error(mine: dict, ref: dict) -> float:
    """The worst max|a - b| / max|b| over the running statistics."""
    return max((mine[k] - v).abs().max().item() / (v.abs().max().item() + 1e-12)
               for k, v in ref.items())


def ddp_rank(rank, port, out_dir, cli_cfg):
    """One [ddp] rank: torchrun's environment, maybe_initialize (gloo: the
    ranks share one card), its half of [train]'s batch (scenes regenerated
    from their seeds), DDP_CHECKED_STEPS deterministic steps from rank 0's
    seeded weights (broadcast) with the launches of each counted, then
    DDP_TIMED_STEPS default-mode steps timed, the gradient all-reduce alone,
    and tools.train.main on cli_cfg. Saves its numbers as rank<r>.pt."""
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      WORLD_SIZE=str(DDP_WORLD), RANK=str(rank), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(DDP_WORLD))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    created = maybe_initialize()
    try:
        assert created and dist.get_backend() == "gloo", dist.get_backend()
        res = ddp_rank_body(rank, cli_cfg)
        dist.barrier()
    finally:
        destroy(created)
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


def ddp_rank_body(rank, cli_cfg) -> dict:
    cfg = default_config()
    table = build_class_table(DATASETS_CLASSES)
    n = TRAIN_BATCH // DDP_WORLD
    datasets = [0 if i < TRAIN_BATCH // 2 else 2 for i in range(TRAIN_BATCH)]
    batch, gt, pack = collate(train_scenes(n, SCENE_POINTS, rank * n, N_GTS,
                                           datasets=datasets[rank * n:(rank + 1) * n]), cfg)
    net = UniDet3D(cfg, table, device="cuda")
    if rank == 0:
        seeded_init_(net, 0)
    broadcast_module(net)
    opt = make_optimizer(net.parameters())
    step = make_train_step(net, cfg, opt)
    b, p = to_device(batch, pack, "cuda")
    g = gt_to_device(gt, "cuda")
    res = dict(launches=[], step_ms=[], allreduce_ms=[])
    torch.cuda.reset_peak_memory_stats()

    def counted_step():
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        m = step(b, g, p, torch.Generator().manual_seed(0), host_dataset_ids=batch.dataset_ids)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        res["launches"].append(read_counts())
        assert res["launches"][-1] == TRAIN_LAUNCHES, (rank, res["launches"][-1])
        return m, ms

    torch.use_deterministic_algorithms(True)
    try:
        for i in range(DDP_CHECKED_STEPS):
            m, _ = counted_step()
            if i == 0:
                res.update(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                           grads={k: x.grad.to("cpu", copy=True) for k, x in net.named_parameters()},
                           stats={k: v.to("cpu", copy=True) for k, v in net.state_dict().items()
                                  if "running" in k})
    finally:
        torch.use_deterministic_algorithms(False)
    res["state"] = {k: v.to("cpu", copy=True) for k, v in net.state_dict().items()}
    for _ in range(DDP_TIMED_STEPS):
        dist.barrier()
        res["step_ms"].append(counted_step()[1])
    for _ in range(3):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        average_gradients(opt.params)
        torch.cuda.synchronize()
        res["allreduce_ms"].append((time.perf_counter() - t0) * 1e3)
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    res["n_grad"] = sum(x.numel() for x in opt.params)
    print(f"[ddp] rank {rank}: {n} scenes (datasets {batch.dataset_ids.tolist()}), step 1 "
          f"loss {res['loss']:.6f}, default-mode steps {[round(x, 1) for x in res['step_ms']]} "
          f"ms, gradient all-reduce {[round(x, 2) for x in res['allreduce_ms']]} ms, peak "
          f"{res['peak_gib']:.1f} GiB", flush=True)
    del net, opt, step, b, p, g
    torch.cuda.empty_cache()

    import unidet3d_tpu_torch.train.loop as loop_module

    results = []
    evaluate_fn = loop_module.evaluate

    def recording_evaluate(*args, **kw):
        results.append(evaluate_fn(*args, **kw))
        return results[-1]

    loop_module.evaluate = recording_evaluate
    torch.cuda.synchronize()
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    with loop_records() as rec:
        cli_net, cli_opt = train_cli.main([cli_cfg])
    torch.cuda.synchronize()
    launches = read_counts()
    groups = sum(st["groups"] for st in rec.eval)
    per_step = cli_launches(launches, DDP_CLI_STEPS, groups)
    assert per_step == TRAIN_LAUNCHES, (rank, per_step, launches, groups)
    assert cli_opt.count == DDP_CLI_STEPS
    res.update(cli_state={k: v.to("cpu", copy=True) for k, v in cli_net.state_dict().items()},
               cli_results=results, cli_stats=rec.train, cli_groups=groups,
               cli_scenes=sum(st["scenes"] for st in rec.eval),
               cli_peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    return res


def phase_ddp(batch, gt, pack, table, card, root):
    """[ddp]: data parallelism over torch.distributed on the one card, 2
    ranks over gloo (which stages CUDA tensors through host memory; NCCL
    refuses two ranks on one card), spawned from this process.
    The one-process reference first: [train]'s batch, one step from
    seeded_init_(0) in deterministic mode, and DDP_NOISE_STEPS default-mode
    steps whose differences are the card's run-to-run noise. Then the ranks, 4 scenes
    each: launches per rank per step (37/36/37/6/6/6); the deterministic
    step's loss, every gradient and the running statistics against the
    one-process step within DDP_NOISE_FACTOR x that noise; the parameters
    bit-equal across ranks after 2 steps; step times, the gradient
    all-reduce's ms and each rank's peak memory. Then tools.train.main in
    both ranks (1 epoch of 2 steps at the full config on [loader-train]'s
    on-disk sets, validation on [eval-loop]'s): one checkpoint, written by
    rank 0; equal models; equal metric dicts."""
    # With a level at capacity the ranks would drop other voxels than one
    # process does: different inputs.
    caps = default_config().level_capacities(len(batch.dataset_ids))
    assert all(n < c for n, c in zip(pack.n_valid, caps)), (pack.n_valid, caps)
    noisy = [one_process_step(batch, gt, pack, table, False) for _ in range(DDP_NOISE_STEPS)]
    ref = one_process_step(batch, gt, pack, table, True)
    pairs = list(zip(noisy, noisy[1:]))
    noise = dict(loss=max(abs(a["loss"] - b["loss"]) for a, b in pairs),
                 grads=[r for a, b in pairs for r in grad_ratios(a["grads"], b["grads"])],
                 stats=max(stats_error(a["stats"], b["stats"]) for a, b in pairs))
    del noisy, pairs
    gc.collect()
    torch.cuda.empty_cache()

    names = {0: "scannet", 2: "multiscan", ARKIT: "arkitscenes"}
    cli_cfg = os.path.join(root, "ddp_config.py")
    with open(cli_cfg, "w") as f:
        f.write(CLI_CONFIG.format(batch=TRAIN_BATCH, epochs=1, steps=DDP_CLI_STEPS, val_every=1,
                                  eval_batch=EVAL_BATCH, work=os.path.join(root, "ddp_work"),
                                  **{("arkit" if ds == ARKIT else n): os.path.join(root, n)
                                     for ds, n in names.items()}))
    out_dir = os.path.join(root, "ddp_ranks")
    os.makedirs(out_dir)
    t0 = time.time()
    ctx = torch.multiprocessing.spawn(ddp_rank, args=(free_port(), out_dir, cli_cfg),
                                      nprocs=DDP_WORLD, join=False)
    try:
        while not ctx.join(timeout=10):
            if time.time() - t0 > DDP_TIMEOUT_S:
                raise TimeoutError(f"[ddp] ranks still running after {DDP_TIMEOUT_S} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
    wall = time.time() - t0
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
             for r in range(DDP_WORLD)]

    # The DDP step against the one-process step.
    r0 = ranks[0]
    assert all(r["loss"] == r0["loss"] and r["grad_norm"] == r0["grad_norm"] for r in ranks)
    loss_err = abs(r0["loss"] - ref["loss"])
    loss_bound = DDP_NOISE_FACTOR * max(noise["loss"], 1e-6 * abs(ref["loss"]))
    vs_one = grad_ratios(r0["grads"], ref["grads"])
    worst = {part: max(r for r, n in vs_one if n.startswith("backbone.") == (part == "backbone"))
             for part in ("backbone", "rest")}
    noise_worst = {part: max(r for r, n in noise["grads"]
                             if n.startswith("backbone.") == (part == "backbone"))
                   for part in ("backbone", "rest")}
    stats_err = stats_error(r0["stats"], ref["stats"])
    stats_bound = DDP_NOISE_FACTOR * max(noise["stats"], 1e-6)
    print(f"[ddp] {DDP_WORLD} ranks x {TRAIN_BATCH // DDP_WORLD} scenes on one card over gloo, "
          f"the full config: launches per rank per step "
          + ", ".join(f"{k} {r0['launches'][0][k]}" for k in COUNTERS)
          + f" (asserted on every step of both ranks) | {card}")
    print(f"[ddp] step 1, deterministic, against one process on the {TRAIN_BATCH} scenes: loss "
          f"{r0['loss']:.6f} vs {ref['loss']:.6f} (|diff| {loss_err:.3g}; {DDP_NOISE_STEPS} "
          f"default-mode one-process steps differ by up to {noise['loss']:.3g}), grad_norm {r0['grad_norm']:.5f} vs "
          f"{ref['grad_norm']:.5f}; worst gradient error / bound (backbone: norm, "
          f"{BACKBONE_RTOL:g}; rest: max, {HEAD_RTOL:g}) " + ", ".join(
              f"{k} {worst[k]:.3f} (noise {noise_worst[k]:.3f})" for k in worst)
          + f"; running statistics worst max|diff|/max {stats_err:.3g} (noise "
          f"{noise['stats']:.3g}); each within {DDP_NOISE_FACTOR:g}x the noise | {card}")
    assert loss_err <= loss_bound, (loss_err, loss_bound)
    for part in worst:
        assert worst[part] <= DDP_NOISE_FACTOR * max(noise_worst[part], 1e-3), \
            (part, worst[part], noise_worst[part], vs_one[:5])
    assert stats_err <= stats_bound, (stats_err, stats_bound)
    unequal = [k for k, v in r0["state"].items() if not torch.equal(v, ranks[1]["state"][k])]
    assert not unequal, f"[ddp] ranks differ after {DDP_CHECKED_STEPS} steps: {unequal[:5]}"
    print(f"[ddp] after {DDP_CHECKED_STEPS} steps every parameter and running statistic "
          f"({len(r0['state'])} tensors) bit-equal across ranks | {card}")
    for r, res in enumerate(ranks):
        print(f"[ddp] rank {r}: default-mode step {statistics.median(res['step_ms']):.1f} ms "
              f"(median of {DDP_TIMED_STEPS}; gloo on CUDA tensors blocks the host per "
              f"collective: no measure of NCCL on {DDP_WORLD} cards), gradient all-reduce "
              f"({res['n_grad']} fp32 values) {statistics.median(res['allreduce_ms']):.2f} ms, "
              f"peak "
              f"max_memory_allocated {res['peak_gib']:.1f} GiB (steps), "
              f"{res['cli_peak_gib']:.1f} GiB (tools.train.main) | {card}")

    # tools.train.main in both ranks.
    ckpts = sorted(os.listdir(os.path.join(root, "ddp_work", "checkpoints")))
    assert ckpts == [f"{DDP_CLI_STEPS}.pth"], ckpts
    writers = [r for r, res in enumerate(ranks)
               if any(st["kind"] == "checkpoint" for st in res["cli_stats"])]
    assert writers == [0], writers
    unequal = [k for k, v in r0["cli_state"].items()
               if not torch.equal(v, ranks[1]["cli_state"][k])]
    assert not unequal, f"[ddp] tools.train.main: models differ across ranks: {unequal[:5]}"
    assert len(r0["cli_results"]) == 1 and r0["cli_results"] == ranks[1]["cli_results"]
    (val,) = [st for st in r0["cli_stats"] if st["kind"] == "val"]
    assert val["results"] == r0["cli_results"][0]
    print(f"[ddp] tools.train.main in both ranks: 1 epoch x {DDP_CLI_STEPS} steps, global batch "
          f"{TRAIN_BATCH}, launches per step 37/36/37/6/6/6 in each rank (its validation "
          f"forwards taken out); checkpoints {ckpts}, written by rank 0 only; models equal "
          f"across ranks; validation on {[res['cli_scenes'] for res in ranks]} scenes in "
          f"{[res['cli_groups'] for res in ranks]} groups per rank, gathered: equal metric dicts "
          f"({map_line(val['results'])}); the whole phase {wall:.1f} s | {card}")
    return {name: r0["launches"][0][name] for name in COUNTERS}


# [overfit-small], [overfit] and [prod-ref]: training that learns (the JAX
# package's tests/test_overfit.py and the port's tests/test_torch_overfit.py,
# here on the card) and the eval forward on reference-scale scenes.
OVERFIT_SCENES = 4  # on disk; batches of TRAIN_BATCH draw them with repeats: 1 step an epoch
OVERFIT_SEED = 3
# The bars of tests/test_overfit.py: the mean of the last 3 losses under the
# first 3's over LOSS_FALL, mAP@0.25 above MAP_BAR, mAR@0.25 exactly 1.0.
LOSS_FALL = 5
MAP_BAR = 0.9
# [overfit-small]: tests/test_torch_overfit.py's config and data, but one
# attention head: the attention kernels are compiled for head dim 32 (the
# CPU test's 4 heads of d_model 32 have head dim 8).
OVERFIT_SMALL_MODEL = dict(max_points=1024, voxel_capacity=1024, max_superpoints=48,
                           max_gts=8, query_thr=48, num_planes=(8, 16), d_model=32,
                           num_heads=1, hidden_dim=64, num_layers=2, topk_insts=32)
OVERFIT_SMALL_EPOCHS = 100
OVERFIT_SMALL_LR = 3e-3
# [overfit]: the production widths (default_config: 32..160 planes, 6 decoder
# layers, d_model 256, 8 heads, hidden 1024, bf16) on coherent scenes of
# 20,000 points (data/synthetic.py::coherent_scene: 3 instances of 4,000
# points, 8,000 of floor and wall, ~45 points per superpoint as in ScanNet's
# segmentation: 445 superpoints); the capacities, query_thr and topk_insts
# follow the scene size. The instances are solid boxes, so the voxels do not
# halve from level to level as a scan's surfaces do: a scene holds ~19,800 /
# 18,400 / 11,750 / 3,400 / 720 voxels at levels 0-4, under the levels'
# 65,536 / 32,768 / 16,384 / 8,192 / 4,096 a scene (no drop, asserted).
OVERFIT_SCENE = dict(inst_points=4000, bg_points=8000, sp_per_inst=89, n_bg_sp=178)
OVERFIT_MODEL = dict(max_points=32768, voxel_capacity=65536, max_superpoints=512,
                     query_thr=512, topk_insts=100)
# The lr was picked on the card from 3e-4, 1e-3 and 3e-3 over 300 steps,
# and 3e-4 against 1e-3 again at these capacities: 3e-4 met the bars first
# and held them, 1e-3 met them later and lost them once, 3e-3 never met them
# (PERF.md, Findings). 250 steps: about twice the steps to the bars, so a
# slower run still meets them and the schedule's low-lr tail holds them.
OVERFIT_EPOCHS = 250
OVERFIT_LR = 3e-4
OVERFIT_VAL_EVERY = 10  # in-loop validations: the steps and seconds until the bars are met
OVERFIT_CONFIG = """
from unidet3d_tpu_torch.core.config import default_config
from unidet3d_tpu_torch.core.experiment import DatasetSpec, ExperimentConfig


def get_config():
    return ExperimentConfig(
        model=default_config(**{model!r}), batch_size={batch}, epochs={epochs},
        steps_per_epoch=0, lr={lr!r}, ckpt_interval_epochs={epochs}, ckpt_max_keep=1,
        val_interval_epochs={val_every}, val_last_epochs=0, eval_batch_size={eval_batch},
        seed={seed}, work_dir={work!r},
        datasets=(DatasetSpec("scannet", {data!r}, ann_train="infos.pkl", ann_val="infos.pkl",
                              augment=False),))
"""


def step_launches(cfg) -> dict:
    """The kernel launches of one training step of `cfg`: K1 and K2 once per
    submanifold conv (the input conv, 4 per U-Net level and 4 more in each
    level's tail but the last's: 37 at 5 levels), K1' for each but the input
    conv, and each attention kernel once per decoder layer."""
    convs = 8 * len(cfg.num_planes) - 3
    layers = cfg.num_layers
    return dict(NO_LAUNCHES, subm_conv=convs, subm_conv_dgrad=convs - 1,
                subm_conv_wgrad=convs, flash_attention=layers, flash_attention_dkv=layers,
                flash_attention_dq=layers)


def loss_fell(losses) -> tuple:
    """(mean of the first 3 losses, of the last 3, whether the last fell
    under the first over LOSS_FALL)."""
    early, late = float(np.mean(losses[:3])), float(np.mean(losses[-3:]))
    return early, late, late < early / LOSS_FALL


def bars_met(losses, results) -> bool:
    res = results["scannet"]
    return loss_fell(losses)[2] and res["mAP_0.25"] > MAP_BAR and res["mAR_0.25"] == 1.0


def assert_bars(tag, losses, results):
    early, late, fell = loss_fell(losses)
    res = results["scannet"]
    assert fell, (tag, "loss", early, late)
    assert res["mAP_0.25"] > MAP_BAR and res["mAR_0.25"] == 1.0, (tag, res)
    return early, late


def check_overfit_kernels(tag, exp, card):
    """K1, K1' and K2 (phase_conv) at each (level, Cin, Cout) of
    `exp.model`'s convs on one training batch of its data, and K3 with
    K3-dkv / K3-dq (check_attention) at its decoder's shape (B = TRAIN_BATCH,
    heads, S, head dim 32), bf16, each against its plain version and
    bit-equal on a second launch: [overfit-small]'s narrow channels and one
    head, and [overfit]'s capacities and S = 512 backward, are on no other
    phase's path. Launches not counted."""
    cfg, dev = exp.model, torch.device("cuda")
    data = ConcatDataset(build_datasets(exp, "train"))
    rng = np.random.RandomState(0)
    samples = [data.get(i % len(data), rng) for i in range(TRAIN_BATCH)]
    _, _, pack_np = collate(samples, cfg, rng=rng)
    phase_conv(pack_np, cfg.num_planes, card, backward=True, tag=f"{tag} conv")
    s, hd = cfg.max_superpoints, cfg.d_model // cfg.num_heads
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v, do = (torch.randn(TRAIN_BATCH, cfg.num_heads, s, hd, generator=gen,
                               device=dev).to(torch.bfloat16) for _ in range(4))
    seg = torch.full((TRAIN_BATCH, s), 2, dtype=torch.int32, device=dev)
    for i, smp in enumerate(samples):
        seg[i, :min(int(smp["sp_pts_mask"].max()) + 1, s)] = 1
    errs = check_attention(q, k, v, do, seg, 1.0 / hd ** 0.5, True)[0]
    print(f"[{tag}] attention at this config's shape (B {TRAIN_BATCH} H {cfg.num_heads} L {s} "
          f"head dim {hd}, bf16) against the plain versions, bit-equal on repeat; max abs err "
          + ", ".join(f"{name} {errs[name]:.2e}" for name in COUNTERS if name in errs)
          + f" | {card}")


def overfit_lines(tag, launches_per_step, losses, intervals, res, early, late, card):
    secs = [st["seconds"] / st["steps"] for st in intervals[1:]]  # the first holds the start
    print(f"[{tag}] launches per step: " + ", ".join(
        f"{k} {v}" for k, v in launches_per_step.items() if k in COUNTERS) + f" | {card}")
    print(f"[{tag}] loss at each log interval (steps 1-{len(losses)}): "
          f"{[round(x, 4) for x in losses]}; mean of the first 3 {early:.4f}, of the last 3 "
          f"{late:.4f} (bar: under {early / LOSS_FALL:.4f}); {statistics.median(secs):.3f} s "
          f"per step (median of the log intervals after the first) | {card}")
    print(f"[{tag}] evaluate on the same scenes: " + ", ".join(
        f"{k} {v:.4f}" for k, v in res["scannet"].items()
        if k.startswith(("mAP", "mAR"))) + f" (bars: mAP_0.25 > {MAP_BAR}, mAR_0.25 == 1.0)"
        f" | {card}")


def phase_overfit_small(table, card, root):
    """tests/test_torch_overfit.py on the card: 4 coherent scenes
    (data/synthetic.py::write_coherent_dataset, byte-equal to the JAX test's
    data), its small config with one attention head (the kernels' head dim),
    bf16, 100 one-step epochs of batch 8 at lr 3e-3, seed 3, no augmentation,
    through train() and evaluate(): the kernels at these shapes against their
    plain versions, the launches of every step, and the JAX test's bars."""
    tag = "overfit-small"
    base = os.path.join(root, tag)
    data = os.path.join(base, "scannet")
    write_coherent_dataset(data, OVERFIT_SCENES)
    cfg = default_config(**OVERFIT_SMALL_MODEL)
    exp = ExperimentConfig(
        model=cfg, batch_size=TRAIN_BATCH, epochs=OVERFIT_SMALL_EPOCHS, steps_per_epoch=0,
        lr=OVERFIT_SMALL_LR, work_dir=os.path.join(base, "work"), val_interval_epochs=100000,
        val_last_epochs=0, ckpt_interval_epochs=OVERFIT_SMALL_EPOCHS, seed=OVERFIT_SEED,
        datasets=(DatasetSpec("scannet", data, ann_train="infos.pkl", ann_val="infos.pkl",
                              augment=False),))
    check_overfit_kernels(tag, exp, card)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    with loop_records() as rec:
        net, opt = train(exp, device="cuda")
    torch.cuda.synchronize()
    train_s = time.time() - t0
    launches = read_counts()
    per_step = step_launches(cfg)
    assert opt.count == OVERFIT_SMALL_EPOCHS, opt.count
    assert launches == {k: n * opt.count for k, n in per_step.items()}, (launches, per_step)
    intervals = rec.of("interval")
    losses = [st["loss"] for st in intervals]
    assert len(losses) == opt.count and np.isfinite(losses).all(), losses
    # The JAX test's config subsamples its ~2,000-point scenes to max_points
    # 1,024; nothing else may drop.
    dropped = {k for st in rec.of("drops") for k in st} - {"kind", "step"}
    assert dropped <= {"points_dropped"}, rec.of("drops")
    reset_counts()
    res, stats = evaluate_with_stats(exp, net, "cuda")
    groups = sum(st["groups"] for st in stats)
    assert read_counts() == dict(NO_LAUNCHES, subm_conv=per_step["subm_conv"] * groups,
                                 flash_attention=cfg.num_layers * groups), read_counts()
    early, late = assert_bars(tag, losses, res)
    print(f"[{tag}] train() + evaluate() on the card: {OVERFIT_SCENES} coherent scenes "
          f"(tests/test_torch_overfit.py's data), planes {cfg.num_planes}, d_model "
          f"{cfg.d_model}, {cfg.num_heads} head, {cfg.num_layers} layers, {cfg.compute_dtype}, "
          f"{opt.count} steps of batch {TRAIN_BATCH} at lr {OVERFIT_SMALL_LR}: {train_s:.1f} s "
          f"of training; drops {sorted(dropped)} | {card}")
    overfit_lines(tag, per_step, losses, intervals, res, early, late, card)


def phase_overfit(table, card, root):
    """Training that learns at the production widths: tools.train.main in
    this process with a config file this phase writes (default_config's
    widths, bf16; capacities, query_thr and topk_insts for 20,000-point
    scenes) on OVERFIT_SCENES coherent scenes on disk, batch 8,
    OVERFIT_EPOCHS one-step epochs at OVERFIT_LR, seed 3, no augmentation,
    validation every OVERFIT_VAL_EVERY epochs, then evaluate() on the same
    scenes: the kernels at these shapes against their plain versions first,
    no capacity drop anywhere, the launches of
    every step (37/36/37/6/6/6), the loss at each log interval, the steps and
    seconds until the first validation that met the bars, s per step, the
    mAP dict and the JAX test's bars."""
    tag = "overfit"
    base = os.path.join(root, tag)
    data = os.path.join(base, "scannet")
    write_coherent_dataset(data, OVERFIT_SCENES, **OVERFIT_SCENE)
    cfg_path = os.path.join(base, "overfit_config.py")
    with open(cfg_path, "w") as f:
        f.write(OVERFIT_CONFIG.format(model=OVERFIT_MODEL, batch=TRAIN_BATCH,
                                      epochs=OVERFIT_EPOCHS, lr=OVERFIT_LR,
                                      val_every=OVERFIT_VAL_EVERY, eval_batch=EVAL_BATCH,
                                      seed=OVERFIT_SEED, work=os.path.join(base, "work"),
                                      data=data))
    exp = load_experiment(cfg_path)
    check_overfit_kernels(tag, exp, card)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.time()
    with loop_records() as rec:
        net, opt = train_cli.main([cfg_path])
    torch.cuda.synchronize()
    train_s = time.time() - t0
    launches = read_counts()
    assert opt.count == OVERFIT_EPOCHS, opt.count
    # The loop logs each interval's drops; the last validation's would show
    # only at a later interval.
    assert not rec.of("drops") and not DROPS.snapshot(), (rec.of("drops"), DROPS.snapshot())
    groups = sum(st["groups"] for st in rec.eval)
    per_step = cli_launches(launches, opt.count, groups)
    assert per_step == step_launches(exp.model) == TRAIN_LAUNCHES, (per_step, launches, groups)
    intervals = rec.of("interval")
    losses = [st["loss"] for st in intervals]
    assert len(losses) == opt.count and np.isfinite(losses).all(), losses
    vals = rec.of("val")
    met = next((val for val in vals if bars_met(losses[:val["step"]], val["results"])), None)
    reset_counts()
    res, stats = evaluate_with_stats(exp, net, "cuda")
    assert not DROPS.snapshot(), DROPS.format()
    eval_groups = sum(st["groups"] for st in stats)
    assert read_counts() == dict(NO_LAUNCHES, subm_conv=37 * eval_groups,
                                 flash_attention=6 * eval_groups), read_counts()
    early, late = assert_bars(tag, losses, res)
    n_points = 3 * OVERFIT_SCENE["inst_points"] + OVERFIT_SCENE["bg_points"]
    print(f"[{tag}] tools.train.main at the production widths ({exp.model.compute_dtype}, "
          f"planes {exp.model.num_planes}, {exp.model.num_layers} layers, d_model "
          f"{exp.model.d_model}, {exp.model.num_heads} heads, hidden {exp.model.hidden_dim}) on "
          f"{OVERFIT_SCENES} coherent scenes of {n_points} points (S {exp.model.max_superpoints}"
          f", query_thr {exp.model.query_thr}, topk_insts {exp.model.topk_insts}): {opt.count} "
          f"steps of batch {TRAIN_BATCH} at lr {OVERFIT_LR}, {len(vals)} validations; voxel "
          f"capacities a scene {list(exp.model.level_capacities(1))}, no drops in training, "
          f"validation or evaluate; {train_s:.1f} s, "
          f"peak {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB | {card}")
    overfit_lines(tag, per_step, losses, intervals, res, early, late, card)
    print(f"[{tag}] validations (step: loss bar, mAP_0.25, mAR_0.25): " + "; ".join(
        f"{val['step']}: {loss_fell(losses[:val['step']])[2]}, "
        f"{val['results']['scannet']['mAP_0.25']:.4f}, "
        f"{val['results']['scannet']['mAR_0.25']:.4f}" for val in vals) + f" | {card}")
    assert met is not None, "no validation met the bars"
    train_to = sum(st["seconds"] for st in intervals[:met["step"]])
    print(f"[{tag}] bars first met at the validation after step {met['step']}: "
          f"{rec.at(met) - t0:.1f} s from the CLI's start ({train_to:.1f} s of them in "
          f"training steps, the rest start-up and validations) | {card}")


PROD_REF_REPS = 2  # [prod-ref]'s warm runs per group


def phase_prod_ref(table, card):
    """The production eval path on reference-scale scenes
    (data/synthetic.py::reference_scale_scenes: ScanNet scans of 52k-190k
    points, tests/test_torch_reference_scale_budgets.py's mix) at the
    default config, bf16, in groups of GROUP: collate (native rulebooks),
    to_device, forward, predict_batch. Zero drops, every point valid, 37 K1
    and 6 K3 launches per forward, finite outputs, ms per group (median of
    PROD_REF_REPS warm runs), peak memory."""
    tag = "prod-ref"
    cfg = default_config()
    samples = reference_scale_scenes()
    net = seeded_init_(UniDet3D(cfg, table, device="cuda"), 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n_valid = 0
    for start in range(0, len(samples), GROUP):
        group = samples[start:start + GROUP]
        sizes = [len(smp["points"]) for smp in group]
        DROPS.reset()
        t0 = time.time()
        batch, _, pack = collate(group, cfg)
        pack_s = time.time() - t0
        drops = DROPS.snapshot(reset=True)
        assert not drops, (tag, sizes, DROPS.format(drops))
        assert [int(v.sum()) for v in batch.valid] == sizes, (tag, sizes)
        n_valid += int(batch.valid.sum())
        caps = cfg.level_capacities(len(group))
        assert all(n <= cap for n, cap in zip(pack.n_valid, caps)), (pack.n_valid, caps)

        @torch.no_grad()
        def run():
            b, p = to_device(batch, pack, "cuda")
            out, aux = net(b, p)
            det = predict_batch(cfg, 0, out.cls_logits[-1], out.boxes[-1], aux.query_valid,
                                b.points, b.valid, b.sp_ids)
            torch.cuda.synchronize()
            return out, aux, det

        reset_counts()
        out, aux, det = run()
        launches = read_counts()
        assert launches == dict(NO_LAUNCHES, subm_conv=37, flash_attention=6), launches
        qv = aux.query_valid
        assert torch.isfinite(out.cls_logits[:, qv]).all() and torch.isfinite(
            out.boxes[:, qv]).all(), tag
        kept = int(det.valid.sum().item())
        assert kept > 0 and torch.isfinite(det.boxes[det.valid]).all(), tag
        ms = []
        for _ in range(PROD_REF_REPS):
            t = time.perf_counter()
            run()
            ms.append((time.perf_counter() - t) * 1e3)
        print(f"[{tag}] group of {len(group)} scenes of {sizes} points: no drops, all "
              f"{sum(sizes)} points valid, voxels per level {list(pack.n_valid)} of "
              f"{list(caps)}, {int(qv.sum())} valid queries; launches per forward K1 "
              f"{launches['subm_conv']}, K3 {launches['flash_attention']}; detections kept "
              f"{kept}; host pack {pack_s:.2f} s; group (H2D, forward, predict_batch) "
              f"{statistics.median(ms):.1f} ms, median of {PROD_REF_REPS} | {card}")
    assert n_valid == sum(REFERENCE_SCALE_POINTS), n_valid
    print(f"[{tag}] {len(samples)} scenes, {n_valid} points valid of "
          f"{sum(REFERENCE_SCALE_POINTS)}, zero drops; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB | {card}")


M1_SHAPE = (4, 8, 3092, 3072)  # the cell's largest group: B, H, 20 + 3,072 queries, keys
M1_REPS = 10


def m1_inputs(density, blocks=False, seed=0):
    """q, k, v (B, H, Lq, 32) / (B, H, Lk, 32) bf16 and the (B, Lq, Lk) bool
    mask at M1_SHAPE: random bits of the given density, or (blocks) bit (i,
    j) open where the 64-row block of i and the 64-key block of j agree mod
    round(1 / density), so that whole tiles are closed."""
    dev = torch.device("cuda")
    b, h, lq, lk = M1_SHAPE
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn((b, h, n, 32), generator=gen, device=dev).to(torch.bfloat16)
               for n in (lq, lk, lk))
    if blocks:
        period = round(1 / density)
        rows = torch.arange(lq, device=dev) // 64 % period
        mask = (rows[:, None] == torch.arange(lk, device=dev)[None, :] // 64 % period)
        mask = mask[None].expand(b, -1, -1).contiguous()
    else:
        mask = torch.rand((b, lq, lk), generator=gen, device=dev) < density
    return q, k, v, mask


def m1_times(q, k, v, bits, q_len, k_len, scale):
    """(M1 ms, plain ms, SDPA ms with a boolean mask, open pairs of the
    valid rows) of one launch's inputs."""
    lq, lk = q.shape[2], k.shape[2]
    rows = torch.arange(lq, device=q.device)[None, :] < q_len[:, None]
    keys = torch.arange(lk, device=q.device)[None, :] < k_len[:, None]
    mask = unpack_bits(bits, lk) & rows[:, :, None] & keys[:, None, :]
    pairs = int(mask.sum())
    mask4 = mask[:, None]
    return (cuda_ms(lambda: mask_attention_cuda(q, k, v, bits, q_len, k_len, scale),
                    reps=M1_REPS),
            cuda_ms(lambda: mask_attention_plain(q, k, v, bits, q_len, k_len, scale), reps=2),
            cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask4,
                                                           scale=scale), reps=2),
            pairs)


def m1_bound_ms(pairs, q, k, bits) -> tuple:
    """(bound ms, "bytes" or "operations") of M1 over `pairs` open (query,
    key) pairs: per pair and head the q k and p v products of width 32 and
    one exp (SFU, 16 per clock per SM), against q, k, v, o and the bits
    read or written once."""
    h, hd = q.shape[1], q.shape[3]
    ops_ms = 2.0 * 2 * pairs * h * hd / BF16_FLOPS * 1e3
    exps_ms = pairs * h / (torch.cuda.get_device_properties(0).multi_processor_count
                           * SFU_EXP_PER_CLOCK * sm_clock_hz()) * 1e3
    nbytes = 2 * q.numel() * 2 + 2 * k.numel() * 2 + bits.numel() * 4
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, exps_ms, bytes_ms), "bytes" if bytes_ms >= max(ops_ms, exps_ms) else (
        "operations")


def phase_m1(card, ptxas=()):
    """M1 against its plain version at the cell's shape, timed beside its
    bound, its plain version and SDPA; then the OneFormer3D main path's
    launches, and M1 timed on its own inputs (phase 32 of the module
    docstring). Returns the `kernels` line's numbers, per forward of the
    main path."""
    from unidet3d_tpu_torch.configs.oneformer3d_scannet import get_config as of3d_config
    from unidet3d_tpu_torch.models import oneformer3d
    from unidet3d_tpu_torch.models.instance_postprocess import predict_instances

    tag = "m1"
    for name, stats in ptxas:
        print(f"[{tag}] ptxas: {ptxas_line(name, stats)}")
    b, h, lq, lk = M1_SHAPE
    scale = 32 ** -0.5
    dev = torch.device("cuda")
    full_q = torch.full((b,), lq, dtype=torch.int32, device=dev)
    full_k = torch.full((b,), lk, dtype=torch.int32, device=dev)
    for density, blocks in ((0.25, False), (0.5, False), (1.0, False), (0.25, True)):
        q, k, v, mask = m1_inputs(density, blocks)
        mask[:, 1] = False  # a closed row: zeros
        q_len = full_q - torch.arange(b, dtype=torch.int32, device=dev) * 37
        k_len = full_k - torch.arange(b, dtype=torch.int32, device=dev) * 29
        bits = pack_bits(mask)
        out = mask_attention_cuda(q, k, v, bits, q_len, k_len, scale)
        again = mask_attention_cuda(q, k, v, bits, q_len, k_len, scale)
        ref = mask_attention_plain(q, k, v, bits, q_len, k_len, scale)
        torch.testing.assert_close(out.float(), ref.float(), **attention_tol(ref))
        assert torch.equal(out, again), (tag, density, blocks)
        assert not out[:, :, 1].any(), (tag, "closed row")
        for i in range(b):
            assert not out[i, :, int(q_len[i]):].any(), (tag, "rows past q_len")
        err = (out.float() - ref.float()).abs().max().item()
        if density < 1:  # the tolerance tells a kernel that ignored the bits
            wrong = mask_attention_plain(q, k, v, pack_bits(torch.ones_like(mask)), q_len,
                                         k_len, scale)
            try:
                torch.testing.assert_close(wrong.float(), ref.float(), **attention_tol(ref))
            except AssertionError:
                pass
            else:
                raise AssertionError((tag, "the tolerance passes unmasked attention"))
        ms, plain_ms, sdpa_ms, pairs = m1_times(q, k, v, bits, full_q, full_k, scale)
        bound, by = m1_bound_ms(pairs, q, k, bits)
        print(f"[{tag}] B {b} H {h} Lq {lq} Lk {lk} {'blocks of 64' if blocks else 'random'} "
              f"{density:.0%} open ({pairs} pairs): max err {err:.2e} (bf16 tol) bit-equal; "
              f"M1 {ms:.4f} ms bound {bound:.4f} ms ({by}; {100 * bound / ms:.1f} %) plain "
              f"{plain_ms:.3f} ms sdpa {sdpa_ms:.3f} ms a launch | {card}")
        del q, k, v, mask, bits, out, again, ref

    # The main path: forward and post-processing at the published widths.
    cfg = of3d_config().model
    samples = sorted(reference_scale_scenes(), key=lambda smp: -len(smp["points"]))[:GROUP]
    sizes = [len(smp["points"]) for smp in samples]
    DROPS.reset()
    batch, _, pack = collate(samples, cfg)
    drops = DROPS.snapshot(reset=True)
    assert not drops, (tag, DROPS.format(drops))
    net = seeded_init_(oneformer3d.OneFormer3D(cfg, device="cuda"), 0)
    captured = []
    kernel = oneformer3d.mask_attention_cuda

    def capture(*args):
        captured.append([a.clone() if torch.is_tensor(a) else a for a in args])
        return kernel(*args)

    @torch.no_grad()
    def run():
        bt, pk = to_device(batch, pack, "cuda")
        out, aux = net(bt, pk)
        pred = predict_instances(cfg, out.cls_logits[-1], out.masks, aux.sp_valid,
                                 aux.sp_counts)
        torch.cuda.synchronize()
        return out, aux, pred

    run()  # warm-up
    oneformer3d.mask_attention_cuda = capture
    try:
        reset_counts()
        mask_attention_cuda.launches = 0
        out, aux, pred = run()
        launches, m1 = read_counts(), mask_attention_cuda.launches
    finally:
        oneformer3d.mask_attention_cuda = kernel
    assert launches == dict(NO_LAUNCHES, subm_conv=37, flash_attention=6), launches
    assert m1 == cfg.num_layers == len(captured), (m1, len(captured))
    qv = aux.query_valid
    assert torch.isfinite(out.cls_logits[:, qv]).all() and torch.isfinite(out.masks[qv]).all()
    ms = []
    for _ in range(3):
        t = time.perf_counter()
        run()
        ms.append((time.perf_counter() - t) * 1e3)
    total = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, max_abs_err=0.0)
    ops_ms = bytes_ms = 0.0
    per_layer = []
    all_pairs = int((qv.sum(1) * aux.sp_valid.sum(1)).sum())
    for args in captured:
        q, k, v, bits, q_len, k_len, sc = args
        ref = mask_attention_plain(q, k, v, bits, q_len, k_len, sc)
        got = kernel(q, k, v, bits, q_len, k_len, sc)
        torch.testing.assert_close(got.float(), ref.float(), **attention_tol(ref))
        t_m1, t_plain, t_sdpa, pairs = m1_times(q, k, v, bits, q_len, k_len, sc)
        bound, by = m1_bound_ms(pairs, q, k, bits)
        total["ms"] += t_m1
        total["plain_ms"] += t_plain
        total["library_ms"] += t_sdpa
        total["bound_ms"] += bound
        total["max_abs_err"] = max(total["max_abs_err"],
                                   (got.float() - ref.float()).abs().max().item())
        (bytes_ms, ops_ms) = (bytes_ms + bound, ops_ms) if by == "bytes" else (
            bytes_ms, ops_ms + bound)
        per_layer.append(f"{pairs} pairs ({100 * pairs / all_pairs:.1f} % of the valid rows' "
                         f"valid keys) {t_m1:.4f} ms")
    print(f"[{tag}] main path: OneFormer3D, group of {len(samples)} scenes of {sizes} points, "
          f"{int(aux.sp_valid.sum())} valid superpoints, no drops; launches per forward K1 "
          f"{launches['subm_conv']}, K3 {launches['flash_attention']}, M1 {m1}; instances kept "
          f"{int(pred.keep.sum())}; group (H2D, forward, predict_instances) "
          f"{statistics.median(ms):.1f} ms, median of 3; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB | {card}")
    print(f"[{tag}] main path's M1 launches, on their own inputs: " + "; ".join(per_layer))
    print(f"[{tag}] per forward: M1 {total['ms']:.4f} ms, bound {total['bound_ms']:.4f} ms "
          f"({100 * total['bound_ms'] / total['ms']:.1f} %), plain {total['plain_ms']:.3f} ms, "
          f"sdpa (bool mask) {total['library_ms']:.3f} ms, max err {total['max_abs_err']:.2e} "
          f"| {card}")
    return dict(total, launches=m1, bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's chip smoke needs the card",
              file=sys.stderr)
        return 1
    t_start = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"[card] {card}; torch {torch.__version__} CUDA {torch.version.cuda}")

    ptxas = phase_build()
    probe = phase_probe(card)
    cfg = default_config()
    table = build_class_table(DATASETS_CLASSES)
    # The eval group: ScanNet's flags; its ground truth is read by [map] only.
    samples = train_scenes(GROUP, SCENE_POINTS, 0, N_GTS, datasets=(0,) * GROUP)
    _, _, pack_np = collate(samples, cfg)
    phase_conv(pack_np, cfg.num_planes, card, backward=False,
               ptxas=ptxas.get("subm_conv", ()))
    n_sp = [min(int(s["sp_pts_mask"].max()) + 1, cfg.max_superpoints) for s in samples]
    phase_attention(n_sp, cfg.max_superpoints, card, backward=False,
                    ptxas=ptxas.get("attention", ()))
    trim = phase_sp_trim(card, ptxas=ptxas.get("sp_trim", ()))
    pool = phase_pool(card, ptxas=ptxas.get("point_pool", ()))
    phase_e2e_small(table, card)
    prod, trims = phase_production(samples, table, card)
    rot_samples = train_scenes(GROUP, SCENE_POINTS, 20, N_GTS, datasets=(ARKIT,) * GROUP)
    prod_rot, _ = phase_production(rot_samples, table, card, dataset_idx=ARKIT, tag="prod-rot")
    phase_map([(0, samples, *prod), (ARKIT, rot_samples, *prod_rot)], card)
    del prod, prod_rot

    train_samples = train_scenes(TRAIN_BATCH, SCENE_POINTS, 0, N_GTS)
    t0 = time.time()
    batch, gt, pack = collate(train_samples, cfg)
    pack_s = time.time() - t0
    conv = phase_conv(pack, cfg.num_planes, card, backward=True,
                      ptxas=ptxas.get("subm_conv_wgrad", ()))
    n_q = [min(int(s["sp_pts_mask"].max()) + 1, cfg.query_thr) for s in train_samples]
    attn = phase_attention(n_q, cfg.max_superpoints, card, backward=True,
                           ptxas=ptxas.get("attention_bwd", ()))
    phase_train_small(table, card)
    phase_train_rot_small(table, card)
    launches = phase_train(batch, gt, pack, pack_s, table, card)
    t0 = time.time()
    rot_batch, rot_gt, rot_pack = collate(
        train_scenes(TRAIN_BATCH, SCENE_POINTS, 0, N_GTS, datasets=ROT_TRAIN_DATASETS), cfg)
    phase_train(rot_batch, rot_gt, rot_pack, time.time() - t0, table, card, tag="train-rot",
                steps=ROT_TRAIN_STEPS)
    native_s = phase_native_pack([("prod group", samples), ("train batch", train_samples)], card)
    phase_device_pack(samples, table, card, native_s["prod group"])
    with tempfile.TemporaryDirectory(prefix="chip_smoke_data_") as root:
        loader_sustained = phase_loader_train(table, card, root)
        eval_exp, eval_s = phase_eval_loop(table, card, root)
        phase_eval_small(table, card, root)
        cli = phase_train_cli(card, root, loader_sustained)
        phase_test_cli(card, cli)
        phase_resume(card, cli)
        phase_load_from(card, root, cli, table)
        del cli
        phase_show_dir(eval_exp, eval_s, table, card, root)
        phase_record_activations(card, root)
        phase_parity_eval(card, root)
        phase_prep(table, card, root)
        ddp_launches = phase_ddp(batch, gt, pack, table, card, root)
        phase_overfit_small(table, card, root)
        phase_overfit(table, card, root)
    phase_prod_ref(table, card)
    m1 = phase_m1(card, ptxas=ptxas.get("mask_attention", ()))
    assert ddp_launches == {name: launches[name] for name in COUNTERS}, ddp_launches

    sources = {
        "subm_conv": ("unidet3d_tpu_torch/csrc/subm_conv.cu",
                      "unidet3d_tpu/ops/pallas_conv.py:477"),
        "subm_conv_dgrad": ("unidet3d_tpu_torch/csrc/subm_conv.cu",
                            "unidet3d_tpu/ops/pallas_conv.py:1164"),
        "subm_conv_wgrad": ("unidet3d_tpu_torch/csrc/subm_conv_wgrad.cu",
                            "unidet3d_tpu/ops/pallas_conv.py:838"),
        "flash_attention": ("unidet3d_tpu_torch/csrc/attention.cu",
                            "unidet3d_tpu/models/decoder.py:71"),
        "flash_attention_dkv": (
            "unidet3d_tpu_torch/csrc/attention_bwd.cu",
            "jax/experimental/pallas/ops/tpu/flash_attention.py:941"),
        "flash_attention_dq": (
            "unidet3d_tpu_torch/csrc/attention_bwd.cu",
            "jax/experimental/pallas/ops/tpu/flash_attention.py:1287"),
    }
    kernels = []
    for name, (source, replaces) in sources.items():
        if name in conv:
            num = conv[name]
        else:  # per call: times the calls per step
            per_call = attn[name]
            num = {key: val * launches[name] if key.endswith("ms") else val
                   for key, val in per_call.items()}
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name], max_abs_err=num["max_abs_err"], ms=num["ms"],
            plain_ms=num["plain_ms"], bound_ms=num["bound_ms"],
            bound_by=num["bound_by"], library_ms=num["library_ms"]))
    kernels.append(dict(
        name="sp_trim", route="cuda", source="unidet3d_tpu_torch/csrc/sp_trim.cu",
        replaces=None, launches=trims,
        **{key: trim[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                      "library_ms")}))
    kernels.append(dict(
        name="point_pool", route="cuda", source="unidet3d_tpu_torch/csrc/point_pool.cu",
        replaces=None, launches=launches["point_pool"],
        **{key: pool[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                      "library_ms")}))
    kernels.append(dict(
        name="mask_attention", route="cuda", source="unidet3d_tpu_torch/csrc/mask_attention.cu",
        replaces=None, **{key: m1[key] for key in ("launches", "max_abs_err", "ms", "plain_ms",
                                                   "bound_ms", "bound_by", "library_ms")}))
    for name, num in probe.items():
        kernels.append(dict(
            name=name, route="cuda", source="unidet3d_tpu_torch/csrc/subm_conv.cu",
            replaces="scripts/probe_conv_bottleneck.py:128",
            **{key: num[key] for key in ("launches", "max_abs_err", "ms", "plain_ms",
                                         "bound_ms", "bound_by", "library_ms")}))
    print("[kernels] launches are one production training step's; ms, plain_ms, "
          "bound_ms and library_ms are per training step at its shapes (8 scenes); "
          "sp_trim: replaces no TPU kernel, on no training path; launches from one eval "
          "forward and post-processing of a group of 4 (phase 6), every number per group of 4 "
          "at [sp-trim]'s shapes, no library call computes it; "
          "point_pool (G1): replaces no TPU kernel; launches: one forward and one backward "
          "call per training step (asserted in [train]; one forward call per eval forward, "
          "asserted in [prod]), every number per step at [pool]'s shapes (the staged cell's "
          "8 x 196,608 slots), forward + backward; library: index_select / index_add_; "
          "the attention bounds count one exp per pair at 16 per clock per SM. "
          "mask_attention (M1): replaces no TPU kernel, on no training or UniDet3D path; "
          "launches and every number per OneFormer3D forward of a group of 4 at [m1]'s "
          "main path, on its 6 launches' own inputs; library: SDPA with a boolean mask. "
          "probe_conv_*: on no training or eval path (0 launches per step, asserted); "
          "launches from one run of the probe's modes, every number per probe call "
          "(one 131,072-point scene, level 0, 32->32, bf16; bound: the bytes over 3.35 TB/s "
          "against the operations the mode's function needs over 989 TFLOP/s bf16; "
          "library: index_select+mm, embedding_bag, einsum, einsum). Also counted and "
          "asserted on their own paths: [ddp] the same launches per rank per step, "
          "[device-pack] 37 K1 and 6 K3 in the forward without a pack, and 37 K1 and 6 K3 "
          "per forward in [show-dir] (evaluate with show_dir), [record-activations] "
          "(tools.record_activations), [parity-eval] (tools.parity_eval), [prep] "
          "(evaluate on the prepared datasets) and [prod-ref] (reference-scale scenes), "
          "the launches of every training step in [overfit] (37/36/37/6/6/6) and "
          "[overfit-small] (13/12/13/2/2/2: 2 levels, 2 layers)")
    print(f"[time] the whole script: {time.time() - t_start:.1f} s | {card}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
