"""Chip smoke test of the PyTorch/CUDA port (``unidet3d_tpu_torch``) on one
NVIDIA GPU. Run from the repository root on a machine with the card and nvcc:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. build the Hopper kernels (subm conv forward K1 and weight gradient K2,
     flash attention forward K3 and backward K3-dkv / K3-dq) with nvcc, one
     process per source, all at once;
  2. K1, the submanifold conv, against its plain PyTorch version at every
     distinct (level, Cin, Cout) shape of the 37 convs of one forward, on the
     neighbor tables of 4 synthetic 131k-point scenes (the production eval
     group), bf16 inputs;
  3. K3, the segment-masked flash attention, against its plain version at
     B=4, H=8, Q=3072, head dim 32, bf16;
  4. the whole eval forward on the card (through K1 and K3) against the same
     forward on the CPU (plain versions), fp32, one 16k-point scene;
  5. the production eval path at full width, bf16: collate -> to_device ->
     forward -> predict_batch on the 4 scenes, with the kernel launches of
     one run counted (37 K1 and 6 K3 per forward) and the warm group time,
     then one group under torch.profiler (device time by kernel, idle share);
  6. K1, K1' (the conv input gradient: K1 on the mirrored weights) and K2
     (the conv weight gradient) against their plain versions at every
     distinct (level, Cin, Cout) of the training step, on the neighbor
     tables of the 8-scene training batch, bf16 (phase 2's code);
  7. K3 with its logsumexp, and K3-dkv / K3-dq against the plain backward, at
     B=8, H=8, L=3072, head dim 32, in bf16 and in fp32 (phase 3's code);
  8. one fp32 training step on the card against the same step on the CPU,
     at full width on two small scenes: loss and every gradient, with the
     card's run-to-run noise read first and the held step run in PyTorch's
     deterministic mode;
  9. the production training step at full width, bf16: 8 synthetic
     131k-point scenes (4 with ScanNet's flags, 4 with MultiScan's) with
     ground truth, 6 steps of make_train_step on the same collated batch,
     the kernel launches of every step counted (K1 37, K1' 36, K2 37, K3 6,
     K3-dkv 6, K3-dq 6), a falling loss, the warm step split into H2D,
     forward + loss, backward and optimizer, then one step under
     torch.profiler;
 10. the `kernels` JSON line (per training step), the card's name and power
     limit, and the final JSON line.
Times are CUDA-event means or synchronised host-clock medians on the card in
this run.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from unidet3d_tpu_torch.core.class_table import build_class_table
from unidet3d_tpu_torch.core.config import DATASETS_CLASSES, default_config
from unidet3d_tpu_torch.data.batcher import collate, gt_to_device, to_device
from unidet3d_tpu_torch.data.synthetic import stripe_superpoints, synthetic_scene
from unidet3d_tpu_torch.losses.criterion import match_scene
from unidet3d_tpu_torch.models.detector import UniDet3D, detection_loss, prepare_gt
from unidet3d_tpu_torch.models.postprocess import predict_batch
from unidet3d_tpu_torch.ops import cuda_build
from unidet3d_tpu_torch.ops.attention import (
    attention_bwd_plain,
    attention_plain,
    flash_attention_cuda,
    flash_attention_dkv_cuda,
    flash_attention_dq_cuda,
)
from unidet3d_tpu_torch.ops.sparse_conv import subm_conv, subm_conv_dgrad, subm_conv_wgrad
from unidet3d_tpu_torch.ops.subm_conv_cuda import (
    subm_conv_cuda,
    subm_conv_dgrad_cuda,
    subm_conv_wgrad_cuda,
)
from unidet3d_tpu_torch.parallel.train_step import make_train_step
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
# The kernels, in the order of the `kernels` line.
COUNTERS = {
    "subm_conv": subm_conv_cuda,
    "subm_conv_dgrad": subm_conv_dgrad_cuda,
    "subm_conv_wgrad": subm_conv_wgrad_cuda,
    "flash_attention": flash_attention_cuda,
    "flash_attention_dkv": flash_attention_dkv_cuda,
    "flash_attention_dq": flash_attention_dq_cuda,
}
TRAIN_LAUNCHES = {"subm_conv": 37, "subm_conv_dgrad": 36, "subm_conv_wgrad": 37,
                  "flash_attention": 6, "flash_attention_dkv": 6,
                  "flash_attention_dq": 6}
# One bf16 ulp relative to the value (8-bit mantissa): two bf16 results of
# the same fp32 sums taken in another order differ by at most this.
BF16_ULP = 2.0 ** -7
# The fp32 card training step against the CPU's, per gradient tensor. Runs
# of the card step with PyTorch's default algorithms (atomic sums) differ from
# each other in the backbone's gradients about 300x more, relative to the
# tensor, than in the rest's (decoder, heads: reached first by the backward),
# as much as the card differs from the CPU. Phase 8 prints that noise over
# NOISE_STEPS runs in every run (PERF.md keeps the readings); each bound is
# about 3x it.
NOISE_STEPS = 6
BACKBONE_RTOL = 2e-2  # |a - b| <= BACKBONE_RTOL |b| + 1e-8, in norm
HEAD_RTOL = 1e-4  # max|a - b| <= HEAD_RTOL max|b| + 1e-8


def reset_counts():
    for fn in COUNTERS.values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in COUNTERS.items()}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=5, warmup=1) -> float:
    """Mean ms per call over `reps` back-to-back calls, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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


def phase_build():
    t0 = time.time()
    reports = cuda_build.build()
    secs = time.time() - t0
    for name, log in reports.items():
        regs = [ln.strip() for ln in log.splitlines() if "Used" in ln]
        print(f"[build] {name}: {'; '.join(regs)}")
    print(f"[build] nvcc for {list(reports) or 'nothing (cached)'}: {secs:.1f} s")


def phase_conv(pack_np, planes, card, backward):
    """K1 -- and with `backward` also K1' and K2 -- against their plain
    versions at each distinct (level, Cin, Cout) of the 37 submanifold
    convs, on this pack's neighbor tables, with bf16 features, weights and
    cotangents. Returns the totals per kernel over one forward (one
    training step with `backward`)."""
    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    names = ("subm_conv", "subm_conv_dgrad", "subm_conv_wgrad")[: 3 if backward else 1]
    tag = "conv-train" if backward else "K1"
    tot = {k: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                   bytes_ms=0.0, ops_ms=0.0, max_abs_err=0.0) for k in names}
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
            err = (out - ref).abs().max().item()
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            t = tot[name]
            t["max_abs_err"] = max(t["max_abs_err"], err)
            ms = cuda_ms(kernel, reps=3)
            plain_ms = cuda_ms(plain, reps=1)
            library_ms = cuda_ms(library, reps=1)
            for key, val in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", library_ms),
                             ("bound_ms", max(bytes_ms, ops_ms)), ("bytes_ms", bytes_ms),
                             ("ops_ms", ops_ms)):
                t[key] += n_calls * val
            row[name] = (f"{ms:.3f}/{plain_ms:.3f}/{library_ms:.3f}/"
                         f"{max(bytes_ms, ops_ms):.4f} err {err:.1e}")
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


def check_attention(q, k, v, do, seg, scale, backward, tol):
    """K3 (with `backward`: its logsumexp, K3-dkv and K3-dq) on q, k, v, do
    against the plain versions, each output within `tol(ref)`, a dict of
    rtol and atol.
    Returns the max abs error per kernel, and the forward's o and lse."""
    o, lse = flash_attention_cuda(q, k, v, seg, scale, return_lse=True)
    ref_o, ref_lse = attention_plain(q, k, v, seg, scale, return_lse=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(o.float(), ref_o.float(), **tol(ref_o), msg="o")
    errs = {"flash_attention": (o.float() - ref_o.float()).abs().max().item()}
    if not backward:
        return errs, o, lse
    torch.testing.assert_close(lse, ref_lse, rtol=1e-4, atol=1e-4)
    di = (o.float() * do.float()).sum(-1)
    dk, dv = flash_attention_dkv_cuda(q, k, v, seg, do, lse, di, scale)
    dq = flash_attention_dq_cuda(q, k, v, seg, do, lse, di, scale)
    ref = attention_bwd_plain(q, k, v, seg, do, lse, di, scale)
    torch.cuda.synchronize()
    diff = {}
    for name, mine, r in (("dq", dq, ref[0]), ("dk", dk, ref[1]), ("dv", dv, ref[2])):
        assert mine.dtype == q.dtype, name
        torch.testing.assert_close(mine.float(), r.float(), **tol(r), msg=name)
        diff[name] = (mine.float() - r.float()).abs().max().item()
    errs["flash_attention_dq"] = diff["dq"]
    errs["flash_attention_dkv"] = max(diff["dk"], diff["dv"])
    return errs, o, lse


def bf16_tol(ref):
    """One bf16 ulp of each value plus 1e-4 of the largest: both sides round
    the same fp32 sums, taken in another order, to bf16."""
    return dict(rtol=BF16_ULP, atol=1e-4 * ref.float().abs().max().item())


def phase_attention(n_valid, s, card, backward):
    """K3 -- and with `backward` also its logsumexp, K3-dkv and K3-dq --
    against the plain versions at the decoder's shape (B = len(n_valid),
    H=8, L=s, head dim 32) in bf16, and with `backward` the same kernels'
    fp32 route at the same shape. Returns per-call numbers per kernel."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    b, h, hd = len(n_valid), 8, 32
    inputs = [torch.randn(b, h, s, hd, generator=gen, device=dev) for _ in range(4)]
    seg = torch.full((b, s), 2, dtype=torch.int32, device=dev)
    for i, n in enumerate(n_valid):
        seg[i, :n] = 1
    scale = 1.0 / hd ** 0.5
    if backward:  # fp32: the same sums in another order, 1e-4 as in the card tests
        errs32 = check_attention(*inputs, seg, scale, True,
                                 lambda ref: dict(rtol=1e-4, atol=1e-4))[0]
    q, k, v, do = (x.to(torch.bfloat16) for x in inputs)
    del inputs
    errs, o, lse = check_attention(q, k, v, do, seg, scale, backward, bf16_tol)
    di = (o.float() * do.float()).sum(-1)

    mask = seg[:, None, :, None] == seg[:, None, None, :]
    times = {"flash_attention": (
        cuda_ms(lambda: flash_attention_cuda(q, k, v, seg, scale, return_lse=backward)),
        cuda_ms(lambda: attention_plain(q, k, v, seg, scale, return_lse=backward), reps=2),
        cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                       scale=scale), reps=2))}
    if backward:
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        sdpa_out = F.scaled_dot_product_attention(*leaves, attn_mask=mask, scale=scale)
        times["flash_attention_dkv"] = (
            cuda_ms(lambda: flash_attention_dkv_cuda(q, k, v, seg, do, lse, di, scale)),
            cuda_ms(lambda: attention_bwd_plain(q, k, v, seg, do, lse, di, scale), reps=2),
            cuda_ms(lambda: torch.autograd.grad(sdpa_out, leaves, do, retain_graph=True),
                    reps=2))
        times["flash_attention_dq"] = (
            cuda_ms(lambda: flash_attention_dq_cuda(q, k, v, seg, do, lse, di, scale)),
            *times["flash_attention_dkv"][1:])
    # Pairs the masks need, and the products per pair each kernel's output
    # needs: forward s, pv (2); dkv s, dp, dv, dk (4); dq s, dp, dq (3).
    pairs = sum(n * n + (s - n) * (s - n) for n in n_valid) * h
    bhs = b * h * s
    work = {
        "flash_attention": (2, 4 * bhs * hd * 2 + (bhs * 4 if backward else 0) + b * s * 4),
        "flash_attention_dkv": (4, 6 * bhs * hd * 2 + 2 * bhs * 4 + b * s * 4),
        "flash_attention_dq": (3, 5 * bhs * hd * 2 + 2 * bhs * 4 + b * s * 4),
    }
    tag = "K3-train" if backward else "K3"
    out = {}
    for name, (ms, plain_ms, library_ms) in times.items():
        products, nbytes = work[name]
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = 2.0 * products * pairs * hd / BF16_FLOPS * 1e3
        out[name] = dict(max_abs_err=errs[name], ms=ms, plain_ms=plain_ms,
                         library_ms=library_ms, bound_ms=max(bytes_ms, ops_ms),
                         bound_by="bytes" if bytes_ms >= ops_ms else "operations")
        fp32 = f" (fp32 route {errs32[name]:.2e})" if backward else ""
        print(f"[{tag}] {name}: B {b} H {h} L {s} valid {list(n_valid)}: bf16 err "
              f"{errs[name]:.2e}{fp32} kernel {ms:.3f} ms plain {plain_ms:.3f} ms "
              f"sdpa {library_ms:.3f} ms bound {out[name]['bound_ms']:.4f} ms per call "
              f"| {card}")
    if backward:
        print(f"[{tag}] the plain and SDPA backward times each cover dq, dk and dv "
              "together; SDPA's are with a boolean mask")
    return out


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


def phase_production(samples, table, card, reps=3):
    """The production eval path at full width: the kernel launches of one
    run counted from zero, its outputs checked, then its metrics."""
    cfg = default_config()  # full width, bf16, S = 3072, 163840 voxels/scene
    t0 = time.time()
    batch, _, pack = collate(samples, cfg)
    pack_s = time.time() - t0
    net = seeded_init_(UniDet3D(cfg, table, device="cuda"), 0)

    @torch.no_grad()
    def run():
        b, p = to_device(batch, pack, "cuda")
        out, aux = net(b, p)
        det = predict_batch(cfg, 0, out.cls_logits[-1], out.boxes[-1],
                            aux.query_valid, b.points, b.valid, b.sp_ids)
        torch.cuda.synchronize()
        return out, aux, det

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    out, aux, det = run()  # the main-path run whose launches are counted
    launches = read_counts()
    assert launches == dict(dict.fromkeys(COUNTERS, 0), subm_conv=37,
                            flash_attention=6), launches
    nq = cfg.max_superpoints
    assert out.cls_logits.shape == (cfg.num_layers + 1, GROUP, nq, 85)
    assert out.boxes.shape == (cfg.num_layers + 1, GROUP, nq, 7)
    qv = aux.query_valid
    assert torch.isfinite(out.cls_logits[:, qv]).all()
    assert torch.isfinite(out.boxes[:, qv]).all()
    assert det.boxes.shape == (GROUP, cfg.topk_insts, 7)
    kept = int(det.valid.sum().item())
    assert kept > 0 and torch.isfinite(det.boxes[det.valid]).all()

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
            predict_batch(cfg, 0, out.cls_logits[-1], out.boxes[-1],
                          aux.query_valid, b.points, b.valid, b.sp_ids)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        group.append((t3 - t0) * 1e3)
        h2d.append((t1 - t0) * 1e3)
        fwd.append((t2 - t1) * 1e3)
        post.append((t3 - t2) * 1e3)
    g = statistics.median(group)
    n_sp = int(aux.query_valid.sum().item())
    print(f"[prod] {GROUP} scenes x {SCENE_POINTS} pts, voxels/level "
          f"{list(pack.n_valid)}, {n_sp} valid queries | {card}")
    print(f"[prod] host pack (numpy rulebooks) {pack_s:.2f} s | {card}")
    print(f"[prod] warm median group {g:.1f} ms over {reps} runs "
          f"({GROUP / (g / 1e3):.2f} scenes/s): H2D {statistics.median(h2d):.1f} ms, "
          f"forward {statistics.median(fwd):.1f} ms, post-processing "
          f"{statistics.median(post):.1f} ms, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB | {card}")
    print(f"[prod] launches per forward: K1 {launches['subm_conv']}, "
          f"K3 {launches['flash_attention']}; detections kept {kept} | {card}")
    phase_profile(run, card, "one group")


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


def train_scenes(n_scenes, n_points, seed0, n_gts):
    """Synthetic training scenes with ground truth: the first half with
    ScanNet's flags (host superpoint masks, boxes from instance masks), the
    rest with MultiScan's (raw boxes, distance top-k masks). Instance k is
    the run of SP_PER_GT consecutive stripe superpoints from k * SP_PER_GT,
    its box the bounds of its points."""
    samples = []
    for i in range(n_scenes):
        ds = 0 if i < n_scenes // 2 else 2
        rng = np.random.RandomState(seed0 + i)
        pts = synthetic_scene(n_points, seed=seed0 + i)
        sp = stripe_superpoints(pts, SP_SIZE)
        inst_of_sp = np.full(int(sp.max()) + 1, -1)
        inst_of_sp[: n_gts * SP_PER_GT] = np.arange(n_gts * SP_PER_GT) // SP_PER_GT
        inst = inst_of_sp[sp]
        lo = np.stack([pts[inst == k, :3].min(0) for k in range(n_gts)])
        hi = np.stack([pts[inst == k, :3].max(0) for k in range(n_gts)])
        samples.append({
            "points": pts, "dataset_idx": ds, "sp_pts_mask": sp,
            "gt_bboxes_3d": np.concatenate([(lo + hi) / 2, hi - lo], 1).astype(np.float32),
            "gt_labels_3d": rng.randint(0, len(DATASETS_CLASSES[ds]), n_gts),
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


def phase_train_small(table, card):
    """One fp32 training step at full width on two small scenes, from the
    same weights and the same query draw, on the CPU (plain versions) and
    NOISE_STEPS + 2 times on the card (kernels). The first NOISE_STEPS card
    steps run with PyTorch's default algorithms (index_add_ sums with
    atomics): the worst difference between two successive ones is the
    card's run-to-run noise. The last two run in deterministic mode, must
    agree bit for bit, and the first of them is held against the CPU."""
    n_points = 8192
    cfg = default_config(compute_dtype="float32", max_points=n_points,
                         voxel_capacity=n_points, max_superpoints=256, max_gts=16,
                         query_thr=160)
    batch, gt, pack = collate(train_scenes(2, n_points, 300, n_gts=8), cfg)
    init = seeded_init_(UniDet3D(cfg, table, device="cpu"), 0).state_dict()

    def one(device):
        model = UniDet3D(cfg, table, device=device)
        model.load_state_dict(init)
        step = make_train_step(model, cfg, make_optimizer(model.parameters()))
        b, p = to_device(batch, pack, device)
        m = step(b, gt_to_device(gt, device), p, torch.Generator().manual_seed(3))
        grads = {n: x.grad.detach().cpu() for n, x in model.named_parameters()}
        return float(m["loss"]), float(m["grad_norm"]), grads

    loss_ref, norm_ref, g_ref = one("cpu")
    noisy = [one("cuda")[2] for _ in range(NOISE_STEPS)]
    torch.use_deterministic_algorithms(True)
    reset_counts()
    loss, norm, grads = one("cuda")
    torch.cuda.synchronize()
    launches = read_counts()
    repeat = one("cuda")[2]
    torch.use_deterministic_algorithms(False)
    changed = [n for n in grads if not torch.equal(grads[n], repeat[n])]
    noise = sorted(r for a, b in zip(noisy, noisy[1:]) for r in grad_ratios(a, b))[::-1]
    vs_cpu = grad_ratios(grads, g_ref)
    print(f"[train-small] 2 scenes x {n_points} pts, fp32, full width: loss card "
          f"{loss:.6f} CPU {loss_ref:.6f}, grad_norm card {norm:.5f} CPU {norm_ref:.5f}; "
          f"deterministic repeat differs in {len(changed)} of {len(grads)} gradients "
          f"| {card}")
    print(f"[train-small] worst gradient error / bound (backbone: norm, "
          f"{BACKBONE_RTOL:g}; rest: max, {HEAD_RTOL:g}); {NOISE_STEPS} card steps, "
          f"default algorithms, each vs the next: {worst_by_part(noise)}; card "
          f"(deterministic) vs CPU: {worst_by_part(vs_cpu)} | {card}")
    assert launches == TRAIN_LAUNCHES, launches
    assert not changed, f"the deterministic card step did not repeat: {changed}"
    assert abs(loss - loss_ref) <= 1e-5 * abs(loss_ref), (loss, loss_ref)
    assert abs(norm - norm_ref) <= 1e-4 * norm_ref, (norm, norm_ref)
    ratio, name = vs_cpu[0]
    assert ratio <= 1.0, f"card vs CPU gradient {name}: {ratio:.3f} of its bound"


def phase_train(batch, gt, pack, pack_s, table, card, split_reps=3):
    """The production training step at full width, bf16, on one collated
    8-scene batch: TRAIN_STEPS steps of make_train_step with the launches of
    each counted from zero, then split-timed steps and one profiled step.
    Every step draws the same queries (a generator seeded alike), so the
    loss on the fixed batch must fall."""
    cfg = default_config()
    net = seeded_init_(UniDet3D(cfg, table, device="cuda"), 0)
    opt = make_optimizer(net.parameters())
    step = make_train_step(net, cfg, opt)

    def gen():
        return torch.Generator().manual_seed(0)

    captured = {}
    hook = net.register_forward_hook(
        lambda mod, args, out: captured.__setitem__("out", out))
    torch.cuda.reset_peak_memory_stats()
    losses, norms, step_ms = [], [], []
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        b, p = to_device(batch, pack, "cuda")
        g = gt_to_device(gt, "cuda")
        metrics = step(b, g, p, gen())
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        launches = read_counts()
        assert launches == TRAIN_LAUNCHES, (i, launches)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        if i == 0:
            hook.remove()
            with torch.no_grad():
                out, aux = captured.pop("out")
                sgt = prepare_gt(cfg, b, g, aux)
                topk = torch.as_tensor(cfg.topk, device="cuda")[b.dataset_ids.long()]
                pairs = [match_scene(out.cls_logits[layer], out.boxes[layer], aux.query_valid,
                                     sgt, topk).pair_valid.sum((1, 2)).tolist()
                         for layer in (0, cfg.num_layers)]
            assert all(n > 0 for n in pairs[1]), pairs
            n_gt = gt.valid.sum(1).tolist()
            n_q = aux.query_valid.sum(1).tolist()
            print(f"[train] {TRAIN_BATCH} scenes x {SCENE_POINTS} pts (datasets "
                  f"{batch.dataset_ids.tolist()}), voxels/level {list(pack.n_valid)}, "
                  f"valid queries {n_q}, GTs {n_gt}, matched pairs at step 1 "
                  f"(first / last output set) {pairs[0]} / {pairs[1]} | {card}")
            print(f"[train] launches per step: " + ", ".join(
                f"{k} {v}" for k, v in launches.items()) + f" | {card}")
        print(f"[train] step {i + 1}: loss {losses[-1]:.6f} grad_norm {norms[-1]:.5f} "
              f"step {step_ms[-1]:.1f} ms | {card}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    assert all(np.isfinite(losses)) and all(np.isfinite(norms)), (losses, norms)
    assert losses[-1] < losses[0], f"loss did not fall: {losses}"

    h2d, fwd, bwd, optim = [], [], [], []
    for _ in range(split_reps):  # the step's body, synchronised between parts
        t0 = time.perf_counter()
        b, p = to_device(batch, pack, "cuda")
        g = gt_to_device(gt, "cuda")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out, aux = net(b, p, train=True, generator=gen())
        loss = detection_loss(cfg, out, aux, b, g)
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
    print(f"[train] host pack (numpy rulebooks) {pack_s:.2f} s for {TRAIN_BATCH} scenes | {card}")
    print(f"[train] warm median step {warm:.1f} ms over steps 2-{TRAIN_STEPS} "
          f"({TRAIN_BATCH / (warm / 1e3):.2f} scenes/s), peak {peak:.1f} GiB | {card}")
    print(f"[train] split (median of {split_reps} synchronised steps): H2D {med(h2d):.1f} ms, "
          f"forward+loss {med(fwd):.1f} ms, backward {med(bwd):.1f} ms, optimizer "
          f"{med(optim):.1f} ms | {card}")

    def run():
        b, p = to_device(batch, pack, "cuda")
        step(b, gt_to_device(gt, "cuda"), p, gen())
        torch.cuda.synchronize()

    phase_profile(run, card, "one training step", top=16)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's chip smoke needs the card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"[card] {card}; torch {torch.__version__} CUDA {torch.version.cuda}")

    phase_build()
    cfg = default_config()
    table = build_class_table(DATASETS_CLASSES)
    samples = make_scenes(GROUP, SCENE_POINTS)
    _, _, pack_np = collate(samples, cfg)
    phase_conv(pack_np, cfg.num_planes, card, backward=False)
    n_sp = [min(int(s["sp_pts_mask"].max()) + 1, cfg.max_superpoints) for s in samples]
    phase_attention(n_sp, cfg.max_superpoints, card, backward=False)
    phase_e2e_small(table, card)
    phase_production(samples, table, card)

    train_samples = train_scenes(TRAIN_BATCH, SCENE_POINTS, 0, N_GTS)
    t0 = time.time()
    batch, gt, pack = collate(train_samples, cfg)
    pack_s = time.time() - t0
    conv = phase_conv(pack, cfg.num_planes, card, backward=True)
    n_q = [min(int(s["sp_pts_mask"].max()) + 1, cfg.query_thr) for s in train_samples]
    attn = phase_attention(n_q, cfg.max_superpoints, card, backward=True)
    phase_train_small(table, card)
    launches = phase_train(batch, gt, pack, pack_s, table, card)

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
    print("[kernels] launches are one production training step's; ms, plain_ms, "
          "bound_ms and library_ms are per training step at its shapes (8 scenes)")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
