"""Chip smoke test of the PyTorch/CUDA port (``unidet3d_tpu_torch``) on one
NVIDIA GPU. Run from the repository root on a machine with the card and nvcc:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. build both Hopper kernels (subm conv, flash attention) with nvcc;
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
  6. the `kernels` JSON line, the card's name and power limit, and the final
     JSON line.
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
from unidet3d_tpu_torch.data.batcher import collate, to_device
from unidet3d_tpu_torch.data.synthetic import stripe_superpoints, synthetic_scene
from unidet3d_tpu_torch.models.detector import UniDet3D
from unidet3d_tpu_torch.models.postprocess import predict_batch
from unidet3d_tpu_torch.ops import cuda_build
from unidet3d_tpu_torch.ops.attention import attention_plain, flash_attention_cuda
from unidet3d_tpu_torch.ops.sparse_conv import subm_conv
from unidet3d_tpu_torch.ops.subm_conv_cuda import subm_conv_cuda
from unidet3d_tpu_torch.weights import seeded_init_

# H100 SXM published peaks (NVIDIA data sheet): HBM rate and dense bf16 rate.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
SCENE_POINTS = 131072
GROUP = 4  # the production eval group size
SP_SIZE = 45  # points per superpoint stripe: ~1 superpoint per 45 points


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


def phase_subm_conv(pack_np, planes, card):
    """K1 vs its plain version at each distinct shape, on this group's
    neighbor tables. Returns the per-forward totals."""
    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    totals = dict(ms=0.0, plain_ms=0.0, library_ms=0.0,
                            bytes_s=0.0, ops_s=0.0, bound_ms=0.0)
    max_err = 0.0
    for (lvl, cin, cout), calls in sorted(conv_shapes(planes).items()):
        nbr = torch.from_numpy(pack_np.neighbors[lvl]).to(dev)
        v, n = nbr.shape[0], pack_np.n_valid[lvl]
        feat = torch.from_numpy(rng.randn(v, cin).astype(np.float32))
        feat[n:] = 0.0
        feat = feat.to(dev, torch.bfloat16)
        w = torch.from_numpy(
            (rng.randn(27, cin, cout) / np.sqrt(27 * cin)).astype(np.float32)
        ).to(dev, torch.bfloat16)

        out = subm_conv_cuda(feat, nbr, w, n)
        ref = subm_conv(feat, nbr, w, n)  # fp32 on the same bf16 values
        torch.cuda.synchronize()
        # Same bf16-rounded products, fp32 accumulation in another order.
        torch.testing.assert_close(out, ref, rtol=1e-3, atol=1e-3)
        err = (out - ref).abs().max().item()
        max_err = max(max_err, err)

        padded = torch.cat([feat, feat.new_zeros(1, cin)])
        idx = nbr[:n].reshape(-1).long()

        def library():  # gather + one bf16 GEMM (cuBLAS), the yardstick
            g = padded.index_select(0, idx).view(n, 27 * cin)
            return torch.mm(g, w.view(27 * cin, cout))

        ms = cuda_ms(lambda: subm_conv_cuda(feat, nbr, w, n))
        plain_ms = cuda_ms(lambda: subm_conv(feat, nbr, w, n), reps=3)
        library_ms = cuda_ms(library, reps=3)
        pairs = int((nbr[:n] < v).sum().item())
        nbytes = n * 27 * 4 + n * cin * 2 + 27 * cin * cout * 2 + v * cout * 4
        flops = 2.0 * pairs * cin * cout
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / BF16_FLOPS * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        for key, val in (("ms", ms), ("plain_ms", plain_ms),
                         ("library_ms", library_ms), ("bound_ms", bound_ms)):
            totals[key] += calls * val
        totals["bytes_s"] += calls * bytes_ms
        totals["ops_s"] += calls * ops_ms
        print(f"[K1] level {lvl} {cin}->{cout} x{calls}: rows {n} pairs {pairs} "
              f"err {err:.2e} kernel {ms:.3f} ms plain {plain_ms:.3f} ms "
              f"index_select+mm {library_ms:.3f} ms bound {bound_ms:.4f} ms "
              f"| {card}")
    totals["max_abs_err"] = max_err
    totals["bound_by"] = "bytes" if totals["bytes_s"] >= totals["ops_s"] else "operations"
    return totals


def phase_attention(n_valid_sp, s, card):
    """K3 vs its plain version at the decoder's shape, bf16."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    b, h, hd = len(n_valid_sp), 8, 32
    q, k, v = (torch.randn(b, h, s, hd, generator=gen, device=dev,
                           dtype=torch.bfloat16) for _ in range(3))
    seg = torch.full((b, s), 2, dtype=torch.int32, device=dev)
    for i, n in enumerate(n_valid_sp):
        seg[i, :n] = 1
    scale = 1.0 / hd ** 0.5
    out = flash_attention_cuda(q, k, v, seg, scale)
    ref = attention_plain(q, k, v, seg, scale)
    torch.cuda.synchronize()
    # bf16 outputs (8-bit mantissa) of fp32 softmaxes taken in another order.
    torch.testing.assert_close(out.float(), ref.float(), rtol=1e-2, atol=1e-2)
    err = (out.float() - ref.float()).abs().max().item()

    mask = (seg[:, None, :, None] == seg[:, None, None, :])

    ms = cuda_ms(lambda: flash_attention_cuda(q, k, v, seg, scale))
    plain_ms = cuda_ms(lambda: attention_plain(q, k, v, seg, scale), reps=3)
    library_ms = cuda_ms(
        lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale),
        reps=3,
    )
    # Pairs the masks need: within each scene's valid and padded groups.
    pairs = sum(n * n + (s - n) * (s - n) for n in n_valid_sp) * h
    flops = 4.0 * pairs * hd
    nbytes = 4 * b * h * s * hd * 2 + b * s * 4
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_FLOPS * 1e3
    print(f"[K3] B {b} H {h} Q {s} valid {list(n_valid_sp)}: err {err:.2e} "
          f"kernel {ms:.3f} ms plain {plain_ms:.3f} ms sdpa {library_ms:.3f} ms "
          f"bound {max(bytes_ms, ops_ms):.4f} ms per call | {card}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def phase_e2e_small(table, card):
    """Card forward (kernels) vs CPU forward (plain versions), fp32."""
    n_points = 16384
    cfg = default_config(compute_dtype="float32", max_points=n_points,
                         voxel_capacity=n_points, max_superpoints=512)
    batch, pack = collate(make_scenes(1, n_points, seed0=100), cfg)
    ref_net = seeded_init_(UniDet3D(cfg, table, device="cpu"), 0)
    net = UniDet3D(cfg, table, device="cuda")
    net.load_state_dict(ref_net.state_dict())
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


def phase_production(samples, table, card, reps=5):
    """The production eval path at full width: prints its metrics, returns
    the kernel launches of one run, counted from zero."""
    cfg = default_config()  # full width, bf16, S = 3072, 163840 voxels/scene
    t0 = time.time()
    batch, pack = collate(samples, cfg)
    pack_s = time.time() - t0
    net = seeded_init_(UniDet3D(cfg, table, device="cuda"), 0)

    def run():
        b, p = to_device(batch, pack, "cuda")
        out, aux = net(b, p)
        det = predict_batch(cfg, 0, out.cls_logits[-1], out.boxes[-1],
                            aux.query_valid, b.points, b.valid, b.sp_ids)
        torch.cuda.synchronize()
        return out, aux, det

    torch.cuda.reset_peak_memory_stats()
    subm_conv_cuda.launches = 0
    flash_attention_cuda.launches = 0
    out, aux, det = run()  # the main-path run whose launches are counted
    launches = {"subm_conv": subm_conv_cuda.launches,
                "attention": flash_attention_cuda.launches}
    assert launches == {"subm_conv": 37, "attention": 6}, launches
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
          f"K3 {launches['attention']}; detections kept {kept} | {card}")
    phase_profile(run, card)
    return launches


def phase_profile(run, card, top=12):
    """One production group under torch.profiler: device time by kernel and
    the device's idle share of the group's wall time."""
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
    print(f"[profile] one group: wall {wall_us / 1e3:.1f} ms, device busy "
          f"{busy_us / 1e3:.1f} ms, idle share {idle:.3f} (profiler on) | {card}")
    for name, (n, us) in rows:
        print(f"[profile]   {us / 1e3:8.2f} ms  x{n:<5d} {name[:90]}")


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
    _, pack_np = collate(samples, cfg)
    k1 = phase_subm_conv(pack_np, cfg.num_planes, card)
    n_sp = [min(int(s["sp_pts_mask"].max()) + 1, cfg.max_superpoints) for s in samples]
    k3 = phase_attention(n_sp, cfg.max_superpoints, card)
    phase_e2e_small(table, card)
    launches = phase_production(samples, table, card)
    layers = cfg.num_layers  # K3 calls per forward

    kernels = [
        dict(name="subm_conv", route="cuda", source="unidet3d_tpu_torch/csrc/subm_conv.cu",
             replaces="unidet3d_tpu/ops/pallas_conv.py:477",
             launches=launches["subm_conv"], max_abs_err=k1["max_abs_err"],
             ms=k1["ms"], plain_ms=k1["plain_ms"], bound_ms=k1["bound_ms"],
             bound_by=k1["bound_by"], library_ms=k1["library_ms"]),
        dict(name="flash_attention", route="cuda",
             source="unidet3d_tpu_torch/csrc/attention.cu",
             replaces="unidet3d_tpu/models/decoder.py:71",
             launches=launches["attention"], max_abs_err=k3["max_abs_err"],
             ms=layers * k3["ms"], plain_ms=layers * k3["plain_ms"],
             bound_ms=layers * k3["bound_ms"], bound_by=k3["bound_by"],
             library_ms=layers * k3["library_ms"]),
    ]
    print("[kernels] ms, plain_ms, bound_ms and library_ms are per forward "
          "(K1: its 37 calls; K3: its 6 calls)")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
