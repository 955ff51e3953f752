"""Point-to-superpoint pooling (``ops/point_pool_cuda.py``, G1).

On the CPU: the op's route for CPU tensors against the gather and segment
mean that ``pool_superpoints`` ran before it, bit for bit in value and in
autograd gradient; the kernel's arithmetic in PyTorch (slots sorted by key,
each segment summed in slot order) against that value and gradient, bit
for bit; the autograd Function's plumbing with the kernel replaced by its
plain version; the segments' bounds; the wrapper's refusals. Inputs cover
long padding runs, empty superpoints, voxels whose points lie in two
superpoints and a batch with no padding.

Tests marked ``cuda`` run the kernel pair on the card and skip elsewhere:

    python -m pytest --noconftest -m cuda tests/test_torch_point_pool.py
"""
import numpy as np
import pytest
import torch

from unidet3d_tpu_torch.models.detector import PointBatch, pool_superpoints
from unidet3d_tpu_torch.ops import point_pool_cuda as pp
from unidet3d_tpu_torch.ops.segment import segment_mean, segment_sum
from unidet3d_tpu_torch.ops.sparse_conv import gather_rows

# (valid points per scene of 96 slots, superpoints used per scene of 16,
# channels): a long padding run and an empty scene; most superpoints empty;
# no padding; the production channel count.
CASES = {
    "padding_runs": ((10, 96, 0), 12, 8),
    "empty_superpoints": ((40, 70, 55), 3, 8),
    "no_padding": ((96, 96, 96), 16, 8),
    "wide_rows": ((77, 5, 96), 9, 32),
}
SLOTS, S = 96, 16


def make_case(valid, used, channels, seed=0):
    """feats (V, C) with V = 3 x 48 voxel rows (the sentinel V), pinv (N,)
    int32, sp_flat (N,) int64 (sentinel 3 x 16) and the flat validity, as
    ``voxel_features`` and ``pool_superpoints`` build them: each scene's
    valid points at the front of its slots, several points a voxel, and
    voxels 0 and 1 of each scene split over two superpoints each."""
    rng = np.random.RandomState(seed)
    b, vox = len(valid), 48
    v0 = b * vox
    pinv = np.full(b * SLOTS, v0, np.int32)
    sp = rng.randint(0, S + 5, b * SLOTS)  # padding's ids: anything
    ok = np.zeros(b * SLOTS, bool)
    for i, n in enumerate(valid):
        at = i * SLOTS
        ok[at:at + n] = True
        pinv[at:at + n] = i * vox + rng.randint(0, vox // 2, n)
        sp[at:at + n] = rng.randint(0, used, n)
        if n >= 4:  # one voxel, two superpoints (twice)
            pinv[at:at + 4] = i * vox + np.array([0, 0, 1, 1])
            sp[at:at + 4] = np.array([0, used - 1, 1 % used, (used + 1) // 2])
    sp_flat = np.where(ok, np.arange(b * SLOTS) // SLOTS * S + np.minimum(sp, S - 1), b * S)
    feats = rng.randn(v0, channels).astype(np.float32)
    return (torch.from_numpy(feats), torch.from_numpy(pinv), torch.from_numpy(sp_flat),
            torch.from_numpy(ok), b * S)


def before(feats, pinv, sp_flat, valid, n):
    """The pooling as ``pool_superpoints`` computed it before G1."""
    mean = segment_mean(gather_rows(feats, pinv), sp_flat, n)
    return mean, segment_sum(valid.float(), sp_flat, n)


@pytest.mark.parametrize("case", CASES)
def test_cpu_route_equals_the_gather_and_segment_mean_bit_for_bit(case):
    feats, pinv, sp_flat, valid, n = make_case(*CASES[case])
    cot = torch.randn(n, feats.shape[1], generator=torch.Generator().manual_seed(1))
    a, b = feats.clone().requires_grad_(), feats.clone().requires_grad_()
    mean, counts = pp.point_pool(a, pinv, sp_flat, n)
    ref_mean, ref_counts = before(b, pinv, sp_flat, valid, n)
    assert torch.equal(mean, ref_mean) and torch.equal(counts, ref_counts)
    (mean * cot).sum().backward()
    (ref_mean * cot).sum().backward()
    assert torch.equal(a.grad, b.grad)
    assert (counts == 0).any() or case == "no_padding"


@pytest.mark.parametrize("case", CASES)
def test_forward_mirror_equals_the_plain_mean(case):
    """The forward kernel's arithmetic (slots sorted by superpoint, each
    superpoint's voxel rows summed in slot order, then divided by the
    count) gives the plain path's mean and counts bit for bit."""
    feats, pinv, sp_flat, _, n = make_case(*CASES[case], seed=9)
    mean, counts = pp.pool_forward(feats, pinv, sp_flat, n)
    ref_mean, ref_counts = pp.point_pool_plain(feats, pinv, sp_flat, n)
    assert torch.equal(mean, ref_mean) and torch.equal(counts, ref_counts)


@pytest.mark.parametrize("case", CASES)
def test_backward_mirror_equals_the_plain_gradient(case):
    """The backward kernel's arithmetic (the cotangent over the count,
    slots sorted by voxel, each voxel's rows summed in slot order, padding
    never read) gives autograd's gradient of the plain path, bit for bit."""
    feats, pinv, sp_flat, valid, n = make_case(*CASES[case], seed=2)
    cot = torch.randn(n, feats.shape[1], generator=torch.Generator().manual_seed(3))
    x = feats.clone().requires_grad_()
    mean, counts = pp.point_pool_plain(x, pinv, sp_flat, n)
    (mean * cot).sum().backward()
    mirror = pp.pool_backward(cot, counts, pinv, sp_flat, len(feats))
    assert torch.equal(mirror, x.grad)
    # Voxels of padding and voxels no point reaches get nothing.
    reached = torch.zeros(len(feats), dtype=torch.bool)
    reached[pinv[valid].long()] = True
    assert not mirror[~reached].any() and mirror[reached].abs().sum() > 0


@pytest.mark.parametrize("keys", [[3, 0, 7, 3, -1, 0, 3, 5], [5, 5, 5], [], [0, 1, 2, 3]])
def test_segments_hold_each_key_s_slots_in_slot_order(keys):
    """segments(keys, 5): key k's slots, ascending, at order[off[k]:off[k + 1]]
    (empty runs for absent keys); negative keys before off[0], keys >= 5
    after off[5]."""
    keys = torch.tensor(keys, dtype=torch.int32)
    order, off = pp.segments(keys, 5)
    assert off.dtype == torch.int64 and len(off) == 6
    for k in range(5):
        assert order[off[k]:off[k + 1]].tolist() == torch.nonzero(keys == k).flatten().tolist()
    assert set(order[:off[0]].tolist()) == set(torch.nonzero(keys < 0).flatten().tolist())
    assert set(order[off[5]:].tolist()) == set(torch.nonzero(keys >= 5).flatten().tolist())


@pytest.mark.parametrize("case", CASES)
def test_function_with_plain_kernels_matches_autograd(case, monkeypatch):
    """PointPoolFunction and the card wrappers (sorts, segments, gathers,
    the cotangent's division, the call counters), with the kernel launch
    replaced by its plain version and the device check off: the same mean,
    counts and gradient as autograd through the plain path, one call each
    way; the counts carry no gradient."""
    feats, pinv, sp_flat, _, n = make_case(*CASES[case], seed=4)
    monkeypatch.setattr(pp, "segment_rows_cuda", pp.segment_rows_plain)
    monkeypatch.setattr(pp, "_check", lambda *args: None)
    cot = torch.randn(n, feats.shape[1], generator=torch.Generator().manual_seed(5))
    a, b = feats.clone().requires_grad_(), feats.clone().requires_grad_()
    fwd0, bwd0 = pp.point_pool_cuda.launches, pp.point_pool_bwd_cuda.launches
    mean, counts = pp.PointPoolFunction.apply(a, pinv, sp_flat, n)
    ref_mean, ref_counts = pp.point_pool_plain(b, pinv, sp_flat, n)
    assert torch.equal(mean, ref_mean) and torch.equal(counts, ref_counts)
    assert not counts.requires_grad
    (mean * cot).sum().backward()
    (ref_mean * cot).sum().backward()
    assert torch.equal(a.grad, b.grad)
    assert (pp.point_pool_cuda.launches - fwd0, pp.point_pool_bwd_cuda.launches - bwd0) == (1, 1)


def test_pool_superpoints_on_the_cpu_never_reaches_the_kernels(monkeypatch):
    """pool_superpoints on CPU tensors: the values of the gather and segment
    mean it ran before G1, and neither kernel wrapper is called."""
    def refuse(*args):
        raise AssertionError("a CPU tensor reached the kernel wrapper")

    monkeypatch.setattr(pp, "point_pool_cuda", refuse)
    monkeypatch.setattr(pp, "point_pool_bwd_cuda", refuse)
    rng = np.random.RandomState(6)
    b, p = 3, SLOTS
    valid = torch.from_numpy(np.arange(p)[None, :] < np.array([[20], [96], [0]]))
    sp_ids = torch.from_numpy(rng.randint(-2, S + 3, (b, p)).astype(np.int32))
    batch = PointBatch(None, None, None, valid, sp_ids, None)
    v0 = b * 48
    pinv = torch.where(valid.reshape(-1), torch.from_numpy(
        rng.randint(0, v0, b * p).astype(np.int32)), v0)
    feats = torch.randn(v0, 8, generator=torch.Generator().manual_seed(7), requires_grad=True)
    sp_flat, sp_feats, sp_counts = pool_superpoints(feats, pinv, batch, S)
    sp_feats.sum().backward()
    flat = (torch.arange(b)[:, None] * S + sp_ids.long().clamp(0, S - 1)).reshape(-1)
    want_flat = torch.where(valid.reshape(-1), flat, b * S)
    ref = feats.detach().clone().requires_grad_()
    want_mean, want_counts = before(ref, pinv, want_flat, valid.reshape(-1), b * S)
    want_mean.sum().backward()
    assert torch.equal(sp_flat, want_flat)
    assert torch.equal(sp_feats, want_mean.reshape(b, S, -1))
    assert torch.equal(sp_counts, want_counts.reshape(b, S))
    assert torch.equal(feats.grad, ref.grad)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """The card wrappers check before anything is built or launched; CPU
    tensors are refused there (the op routes them to the plain version)."""
    feats, pinv, sp_flat, _, n = make_case(*CASES["padding_runs"])
    bad = [
        (feats, pinv, sp_flat),  # the CPU
        (feats.double(), pinv, sp_flat),  # not fp32
        (feats, pinv.long(), sp_flat),  # voxel ids not int32
        (feats, pinv, sp_flat.int()),  # superpoint ids not int64
        (feats, pinv, sp_flat[:-1]),  # lengths differ
        (feats[:, 0], pinv, sp_flat),  # not (V, C)
    ]
    for args in bad:
        with pytest.raises(ValueError):
            pp.point_pool_cuda(*args, n)
    with pytest.raises(ValueError):
        pp.point_pool_bwd_cuda(torch.zeros(n, 8), torch.zeros(n), pinv, sp_flat, len(feats))
    off = torch.tensor([0, len(pinv)])
    for args in [(feats, pinv, off),  # the CPU
                 (feats.double(), pinv, off), (feats, pinv.long(), off),
                 (feats, pinv, off.int())]:
        with pytest.raises(ValueError):
            pp.segment_rows_cuda(*args, True)


# ---- on the card ----------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def to_cpu_plain(feats, pinv, sp_flat, n, cot):
    """The plain path on the CPU: (mean, counts, gradient of (mean * cot).sum())."""
    x = feats.cpu().requires_grad_()
    mean, counts = pp.point_pool_plain(x, pinv.cpu(), sp_flat.cpu(), n)
    (mean * cot.cpu()).sum().backward()
    return mean.detach(), counts, x.grad


@pytest.mark.cuda
def test_g1_equals_the_plain_path_bit_for_bit_at_the_staged_shapes(dev):
    """8 x 196,608 slots, ~44 % padding, 885k valid points: G1's mean,
    counts and gradient equal the plain path's on the CPU bit for bit (both
    sum each segment in slot order from +0 and divide alike), and again on
    a second call and in PyTorch's deterministic mode."""
    from unidet3d_tpu_torch.data.synthetic import pool_batch

    feats, pinv, sp_flat, n = (torch.from_numpy(x).to(dev) if isinstance(x, np.ndarray) else x
                               for x in pool_batch(seed=11))
    assert 0.40 < float((pinv == len(feats)).float().mean()) < 0.48
    cot = torch.randn(n, feats.shape[1], generator=torch.Generator(device=dev).manual_seed(1),
                      device=dev)
    ref = to_cpu_plain(feats, pinv, sp_flat, n, cot)

    def g1():
        a = feats.clone().requires_grad_()
        fwd0, bwd0 = pp.point_pool_cuda.launches, pp.point_pool_bwd_cuda.launches
        mean, counts = pp.point_pool(a, pinv, sp_flat, n)
        (mean * cot).sum().backward()
        torch.cuda.synchronize()
        assert (pp.point_pool_cuda.launches - fwd0,
                pp.point_pool_bwd_cuda.launches - bwd0) == (1, 1)
        return mean.detach().cpu(), counts.cpu(), a.grad.cpu()

    first = g1()
    torch.use_deterministic_algorithms(True)
    try:
        again = g1()
    finally:
        torch.use_deterministic_algorithms(False)
    for got in (first, again):
        assert all(torch.equal(x, y) for x, y in zip(got, ref))
    assert not first[2][len(feats) - 1].any()  # past the voxels: no gradient


@pytest.mark.cuda
def test_g1_handles_ragged_rows_and_empty_inputs(dev):
    """C below and above a warp's 32 lanes and no valid point at all, bit
    for bit against the plain path on the CPU."""
    for case, channels in (("padding_runs", 6), ("wide_rows", 40), ("empty_superpoints", 8)):
        valid, used, _ = CASES[case]
        feats, pinv, sp_flat, _, n = make_case(valid, used, channels, seed=8)
        cot = torch.randn(n, channels, generator=torch.Generator().manual_seed(9))
        ref_mean, ref_counts, ref_grad = to_cpu_plain(feats, pinv, sp_flat, n, cot)
        feats, pinv, sp_flat = feats.to(dev), pinv.to(dev), sp_flat.to(dev)
        mean, counts = pp.point_pool_cuda(feats, pinv, sp_flat, n)
        assert torch.equal(mean.cpu(), ref_mean) and torch.equal(counts.cpu(), ref_counts)
        grad = pp.point_pool_bwd_cuda(cot.to(dev), counts, pinv, sp_flat, len(feats))
        assert torch.equal(grad.cpu(), ref_grad)
        mean, counts = pp.point_pool_cuda(feats, pinv, torch.full_like(sp_flat, n), n)
        assert not mean.any() and not counts.any()


def _train_batch(dev):
    """Two small training scenes at the published widths (fp32 routes) and
    the model, optimizer and step that train on them."""
    from unidet3d_tpu_torch.core.class_table import build_class_table
    from unidet3d_tpu_torch.core.config import DATASETS_CLASSES, default_config
    from unidet3d_tpu_torch.data.batcher import collate, gt_to_device, to_device
    from unidet3d_tpu_torch.data.synthetic import stripe_superpoints, synthetic_scene
    from unidet3d_tpu_torch.models.detector import UniDet3D
    from unidet3d_tpu_torch.parallel.train_step import make_train_step
    from unidet3d_tpu_torch.train.optim import make_optimizer
    from unidet3d_tpu_torch.weights import seeded_init_

    n_points, n_inst = 8192, 8
    cfg = default_config(compute_dtype="float32", max_points=n_points, voxel_capacity=n_points,
                         max_superpoints=256, max_gts=16, query_thr=160)
    samples = []
    for i, ds in enumerate((0, 2)):
        pts = synthetic_scene(n_points, seed=i)
        sp = stripe_superpoints(pts, 45)
        inst_of_sp = np.full(int(sp.max()) + 1, -1)
        inst_of_sp[:5 * n_inst] = np.arange(5 * n_inst) // 5
        inst = inst_of_sp[sp]
        lo = np.stack([pts[inst == k, :3].min(0) for k in range(n_inst)])
        hi = np.stack([pts[inst == k, :3].max(0) for k in range(n_inst)])
        samples.append({
            "points": pts, "dataset_idx": ds, "sp_pts_mask": sp,
            "gt_bboxes_3d": np.concatenate([(lo + hi) / 2, hi - lo], 1).astype(np.float32),
            "gt_labels_3d": np.arange(n_inst) % 3,
            "gt_sp_masks": inst_of_sp[None, :] == np.arange(n_inst)[:, None],
            "pts_instance_mask": inst})
    batch, gt, pack = collate(samples, cfg)
    model = seeded_init_(UniDet3D(cfg, build_class_table(DATASETS_CLASSES), device=dev), 0)
    step = make_train_step(model, cfg, make_optimizer(model.parameters()))
    tb, tp = to_device(batch, pack, dev)
    return model, step, tb, tp, gt_to_device(gt, dev), batch.dataset_ids


@pytest.mark.cuda
def test_g1_launches_once_each_way_a_train_step_and_once_an_eval_forward(dev, monkeypatch):
    """The main path on the card: one forward and one backward call a
    training step, one forward call an eval forward, and the plain path
    never runs for CUDA tensors."""
    def refuse(*args):
        raise AssertionError("a CUDA tensor reached the plain pooling")

    monkeypatch.setattr(pp, "point_pool_plain", refuse)
    monkeypatch.setattr(pp, "gather_rows", refuse)
    model, step, batch, pack, gt, ids = _train_batch(dev)
    for _ in range(2):
        fwd0, bwd0 = pp.point_pool_cuda.launches, pp.point_pool_bwd_cuda.launches
        metrics = step(batch, gt, pack, torch.Generator().manual_seed(3), host_dataset_ids=ids)
        torch.cuda.synchronize()
        assert np.isfinite(float(metrics["loss"]))
        assert (pp.point_pool_cuda.launches - fwd0, pp.point_pool_bwd_cuda.launches - bwd0) == (1, 1)
    model.eval()
    fwd0, bwd0 = pp.point_pool_cuda.launches, pp.point_pool_bwd_cuda.launches
    with torch.no_grad():
        model(batch, pack)
    torch.cuda.synchronize()
    assert (pp.point_pool_cuda.launches - fwd0, pp.point_pool_bwd_cuda.launches - bwd0) == (1, 0)


@pytest.mark.cuda
def test_g1_wrappers_refuse_bad_card_inputs(dev):
    feats, pinv, sp_flat, _, n = (x.to(dev) if torch.is_tensor(x) else x
                                  for x in make_case(*CASES["padding_runs"]))
    bad = [
        (feats.half(), pinv, sp_flat),
        (feats, pinv.cpu(), sp_flat),  # another device
        (feats.t(), pinv, sp_flat),  # strided
        (feats, pinv[::2], sp_flat[::2]),  # strided
    ]
    for args in bad:
        with pytest.raises(ValueError):
            pp.point_pool_cuda(*args, n)
