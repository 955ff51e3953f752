"""The port's CUDA kernels against their plain PyTorch versions, on the card:
K1 (conv forward), K1' (conv input gradient), K2 (conv weight gradient), K3
(attention forward, with its logsumexp), K3-dkv / K3-dq (attention
backward) and the four modes of the conv-bottleneck probe, each bf16 kernel
bit-equal on a second launch, plus the two autograd Functions against their
CPU runs, and the host's shared-memory counts of K1 and K2 against the
compiled kernels'.

Every test here needs an NVIDIA GPU (Hopper, sm_90a) and nvcc; elsewhere it
skips. Run on the card from the repository root (the JAX conftest is not
needed and JAX need not be installed):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from unidet3d_tpu_torch.ops.attention import (
    FlashAttentionFunction,
    attention_bwd_plain,
    attention_plain,
    attention_tol,
    flash_attention_cuda,
    flash_attention_dkv_cuda,
    flash_attention_dq_cuda,
)
from unidet3d_tpu_torch.ops.probe_conv import MODES as PROBE_MODES
from unidet3d_tpu_torch.ops.probe_conv import probe_conv_cuda, probe_conv_plain
from unidet3d_tpu_torch.ops.sparse_conv import subm_conv, subm_conv_dgrad, subm_conv_wgrad
from unidet3d_tpu_torch.ops.subm_conv_cuda import (
    WGRAD_INSTANCES,
    SubmConvFunction,
    wgrad_smem,
    conv_tile,
    kernel_smem_bytes,
    subm_conv_cuda,
    subm_conv_dgrad_cuda,
    subm_conv_wgrad_cuda,
    wgrad_kernel_smem_bytes,
    wgrad_tile,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _nbr_table(rng, v, n_valid, fill=0.4):
    """(v, 27) int32 table: rows < n_valid hit random valid rows with
    probability `fill`, centre tap is the row itself, the rest is sentinel."""
    nbr = np.full((v, 27), v, np.int32)
    hit = rng.rand(n_valid, 27) < fill
    nbr[:n_valid] = np.where(hit, rng.randint(0, n_valid, (n_valid, 27)), v)
    nbr[:n_valid, 13] = np.arange(n_valid)
    return nbr


@pytest.mark.parametrize(
    "cin,cout,dtype",
    [
        (6, 32, torch.bfloat16),
        (32, 32, torch.bfloat16),
        (64, 32, torch.float32),
        (96, 96, torch.bfloat16),
        (256, 128, torch.bfloat16),
        (160, 160, torch.float32),
    ],
)
def test_subm_conv_kernel_matches_plain(dev, cin, cout, dtype):
    rng = np.random.RandomState(cin + cout)
    v, n_valid = 3000, 2711  # ragged: neither is a multiple of the 64-row tile
    nbr = torch.from_numpy(_nbr_table(rng, v, n_valid)).to(dev)
    feat = torch.from_numpy(rng.randn(v, cin).astype(np.float32)).to(dev, dtype)
    w = torch.from_numpy(
        (rng.randn(27, cin, cout) / np.sqrt(27 * cin)).astype(np.float32)
    ).to(dev, dtype)
    before = subm_conv_cuda.launches
    out = subm_conv_cuda(feat, nbr, w, n_valid)
    torch.cuda.synchronize()
    assert subm_conv_cuda.launches == before + 1
    ref = subm_conv(feat, nbr, w, n_valid)
    # fp32 accumulation of the same (bf16-rounded) products in another
    # order: differences are a few fp32 ulps of the row sums.
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    assert torch.all(out[n_valid:] == 0)


def _sparse_table(rng, v, n_valid):
    """_nbr_table with holes: rows 640-1023 (six 64-row tiles) have no
    neighbor at all, and rows 1024-1599 none at offsets 0-8, so whole tiles
    skip every offset or some."""
    nbr = _nbr_table(rng, v, n_valid)
    nbr[640:1024] = v
    nbr[1024:1600, :9] = v
    return nbr


# The distinct (Cin, Cout) of the model's 37 convs (chip_smoke.py::
# conv_shapes at the default planes 32..160), the input conv's 6 -> 32 first.
MODEL_CONVS = [(6, 32), (32, 32), (64, 32), (64, 64), (128, 64), (96, 96), (192, 96),
               (128, 128), (256, 128), (160, 160)]


@pytest.mark.parametrize("cin,cout", MODEL_CONVS)
def test_subm_conv_bf16_kernels_match_plain_at_the_model_shapes(dev, cin, cout):
    """K1 and K1' (the bf16 tensor-core route) at every conv shape of the
    model, on a table whose tiles skip some or all offsets, with n_valid not
    a multiple of the 64-row tile; each against its plain version and
    bit-equal on a second launch."""
    rng = np.random.RandomState(cin * 3 + cout)
    v, n_valid = 3000, 2711
    nbr = torch.from_numpy(_sparse_table(rng, v, n_valid)).to(dev)
    feat, g = (torch.from_numpy(rng.randn(v, c).astype(np.float32)).to(dev, torch.bfloat16)
               for c in (cin, cout))
    w = torch.from_numpy(
        (rng.randn(27, cin, cout) / np.sqrt(27 * cin)).astype(np.float32)
    ).to(dev, torch.bfloat16)
    cases = [("K1", subm_conv_cuda, subm_conv, feat)]
    if cin != 6:  # the input conv's input is data: no input gradient
        cases.append(("K1'", subm_conv_dgrad_cuda, subm_conv_dgrad, g))
    for name, kernel, plain, x in cases:
        before = kernel.launches
        out = kernel(x, nbr, w, n_valid)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1, name
        # The same bf16 products (exact in fp32), fp32 sums in another
        # order: chip_smoke.py's 1e-3.
        torch.testing.assert_close(out, plain(x, nbr, w, n_valid), rtol=1e-3, atol=1e-3,
                                   msg=lambda m, n=name: f"{n}: {m}")
        assert torch.all(out[n_valid:] == 0) and torch.all(out[640:1024] == 0), name
        # No split-K, no atomics: the same bits every launch.
        assert torch.equal(out, kernel(x, nbr, w, n_valid)), name


def test_conv_tile_memory_is_the_kernels(dev):
    """conv_tile's shared memory per block (the host's count, checked on the
    CPU for every conv of the model) is what the compiled kernel takes."""
    for cols in (32, 64, 96, 128, 160):
        assert kernel_smem_bytes(cols) == conv_tile(cols).smem
    assert kernel_smem_bytes(48) == -1


@pytest.mark.parametrize(
    "length,ids",
    [(16, "runs"), (16, "random"), (200, "runs"), (200, "random"), (200, "blocks"),
     (3072, "runs"), (3072, "random"), (3072, "blocks")],
)
def test_flash_attention_bf16_kernel_matches_plain_and_repeats(dev, length, ids):
    """K3's tensor-core route with and without the logsumexp: o within
    attention_tol of the plain version (which rounds p to bf16 where the TPU
    kernel does), lse within 1e-4, the same o either way, and the same bits
    on a second launch."""
    q, k, v, _, seg = _attention_inputs(dev, length, torch.bfloat16, length + 5, ids)
    scale = 32 ** -0.5
    before = flash_attention_cuda.launches
    o, lse = flash_attention_cuda(q, k, v, seg, scale, return_lse=True)
    o_eval = flash_attention_cuda(q, k, v, seg, scale)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 2
    ref, ref_lse = attention_plain(q, k, v, seg, scale, return_lse=True)
    torch.testing.assert_close(o.float(), ref.float(), **attention_tol(ref))
    torch.testing.assert_close(lse, ref_lse, rtol=1e-4, atol=1e-4)
    assert torch.equal(o, o_eval)
    again, lse_again = flash_attention_cuda(q, k, v, seg, scale, return_lse=True)
    assert torch.equal(o, again) and torch.equal(lse, lse_again)


@pytest.mark.parametrize(
    "length,dtype", [(3072, torch.bfloat16), (700, torch.float32), (37, torch.bfloat16)]
)
def test_flash_attention_kernel_matches_plain(dev, length, dtype):
    rng = np.random.RandomState(length)
    b, h = 2, 8
    q, k, v = (
        torch.from_numpy(rng.randn(b, h, length, 32).astype(np.float32)).to(dev, dtype)
        for _ in range(3)
    )
    n_ok = [int(length * 0.9), length // 3]
    seg = np.full((b, length), 2, np.int32)
    for i, n in enumerate(n_ok):
        seg[i, :n] = 1
    seg = torch.from_numpy(seg).to(dev)
    before = flash_attention_cuda.launches
    out = flash_attention_cuda(q, k, v, seg, 32 ** -0.5)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 1
    ref = attention_plain(q, k, v, seg, 32 ** -0.5)
    # Online softmax in fp32 vs a one-pass fp32 softmax, both rounded once to
    # the output dtype: attention_tol states the bound.
    torch.testing.assert_close(out.float(), ref.float(), **attention_tol(ref))


def _conv_inputs(dev, cin, cout, dtype, seed):
    rng = np.random.RandomState(seed)
    v, n_valid = 3000, 2711  # ragged: neither is a multiple of the 64-row tile
    nbr = torch.from_numpy(_nbr_table(rng, v, n_valid)).to(dev)
    feat = torch.from_numpy(rng.randn(v, cin).astype(np.float32)).to(dev, dtype)
    g = torch.from_numpy(rng.randn(v, cout).astype(np.float32)).to(dev, dtype)
    w = torch.from_numpy(
        (rng.randn(27, cin, cout) / np.sqrt(27 * cin)).astype(np.float32)
    ).to(dev, dtype)
    return nbr, n_valid, feat, g, w


@pytest.mark.parametrize(
    "cin,cout,dtype",
    [(32, 32, torch.bfloat16), (64, 32, torch.float32), (256, 128, torch.bfloat16),
     (160, 160, torch.bfloat16)],
)
def test_subm_conv_dgrad_route_matches_plain(dev, cin, cout, dtype):
    nbr, n_valid, _, g, w = _conv_inputs(dev, cin, cout, dtype, cin * 7 + cout)
    before = subm_conv_dgrad_cuda.launches
    out = subm_conv_dgrad_cuda(g, nbr, w, n_valid)
    torch.cuda.synchronize()
    assert subm_conv_dgrad_cuda.launches == before + 1
    assert out.shape == (nbr.shape[0], cin) and out.dtype == torch.float32
    ref = subm_conv_dgrad(g, nbr, w, n_valid)
    # K1 on the mirrored weights: the same products, fp32 sums in another order.
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    assert torch.all(out[n_valid:] == 0)


@pytest.mark.parametrize(
    "cin,cout,dtype,holes",
    [(6, 32, torch.bfloat16, False), (32, 32, torch.float32, False),
     (64, 64, torch.bfloat16, False), (96, 96, torch.float32, False),
     (256, 128, torch.bfloat16, False), (160, 160, torch.bfloat16, False),
     (6, 32, torch.bfloat16, True), (32, 32, torch.bfloat16, True),
     (96, 96, torch.bfloat16, True), (192, 96, torch.bfloat16, True)],
)
def test_subm_conv_wgrad_kernel_matches_plain(dev, cin, cout, dtype, holes):
    """K2 against its plain version (bf16: the tensor-core route, whose block
    shape wgrad_tile picks; fp32: the FMA route), with n_valid not a multiple
    of the 32- or 64-row step and the rows past it set to 1e6 (never read).
    With `holes`, the table of _sparse_table loses offsets 0-13 in every
    row: the first offset group of every block shape (at most 14 offsets)
    has no neighbor at all, and whole steps skip every offset."""
    nbr, n_valid, feat, g, _ = _conv_inputs(dev, cin, cout, dtype, cin + cout)
    if holes:
        table = _sparse_table(np.random.RandomState(cin), nbr.shape[0], n_valid)
        table[:, :14] = nbr.shape[0]
        nbr = torch.from_numpy(table).to(dev)
    feat[n_valid:] = 1e6  # rows past n_valid must not be read
    g[n_valid:] = 1e6
    before = subm_conv_wgrad_cuda.launches
    out = subm_conv_wgrad_cuda(feat, nbr, g, n_valid)
    torch.cuda.synchronize()
    assert subm_conv_wgrad_cuda.launches == before + 1
    ref = subm_conv_wgrad(feat, nbr, g, n_valid)
    # The same bf16 (or fp32) products; fp32 sums of ~1,000 pairs each in
    # another order (row splits, then the split sum).
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-3)
    if holes:
        assert torch.all(out[:14] == 0)
    again = subm_conv_wgrad_cuda(feat, nbr, g, n_valid)
    assert torch.equal(out, again)  # no atomics: the same bits every run


def test_wgrad_tile_memory_is_the_kernels(dev):
    """wgrad_tile's shared memory per block (the host's count, checked on
    the CPU at every training shape) is what the compiled K2 takes, for
    every instance of its bf16 route."""
    for mt, nt, gw in WGRAD_INSTANCES:
        assert wgrad_kernel_smem_bytes(16 * mt, 16 * nt) == wgrad_smem(mt, nt, gw)
    for cin, cout in MODEL_CONVS:
        tile = wgrad_tile(cin, cout)
        assert wgrad_kernel_smem_bytes(tile.cin_tile, tile.cout_tile) == tile.smem
    assert wgrad_kernel_smem_bytes(48, 48) == -1


def test_subm_conv_function_on_the_card_matches_cpu(dev):
    from unidet3d_tpu_torch.data.synthetic import synthetic_scene
    from unidet3d_tpu_torch.ops.gridpack import build_gridpack_numpy, quantize_points

    pts = synthetic_scene(6000, seed=5)[None, :, :3]
    valid = np.ones(pts.shape[:2], bool)
    pack, _ = build_gridpack_numpy(
        quantize_points((pts / 0.02).astype(np.float32), valid), valid.reshape(-1), (8192,))
    nbr, n_valid = torch.from_numpy(pack.neighbors[0]), pack.n_valid[0]
    rng = np.random.RandomState(0)
    feat = torch.from_numpy(rng.randn(nbr.shape[0], 32).astype(np.float32))
    w = torch.from_numpy((rng.randn(27, 32, 64) / 30).astype(np.float32))
    g = torch.from_numpy(rng.randn(nbr.shape[0], 64).astype(np.float32))

    def run(device):
        f = feat.clone().to(device).requires_grad_(True)
        ww = w.clone().to(device).requires_grad_(True)
        (SubmConvFunction.apply(f, nbr.to(device), ww, n_valid) * g.to(device)).sum().backward()
        return f.grad.cpu(), ww.grad.cpu()

    before = (subm_conv_cuda.launches, subm_conv_dgrad_cuda.launches,
              subm_conv_wgrad_cuda.launches)
    card = run(dev)
    torch.cuda.synchronize()
    after = (subm_conv_cuda.launches, subm_conv_dgrad_cuda.launches,
             subm_conv_wgrad_cuda.launches)
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]
    cpu = run("cpu")
    # fp32 both sides; the card's dfeat is the mirrored conv (exact on a
    # GridPack table) summed in another order.
    for a, b in zip(card, cpu):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def _attention_inputs(dev, length, dtype, seed, ids="runs"):
    """q, k, v, do (2, 8, length, 32) and (2, length) int32 segment ids:
    "runs" the decoder's (a run of 1s, then 2s), "random" ids drawn from
    {1, 2, 3} per row, "blocks" runs of 50 rows cycling through five ids
    out of order (some tile pairs meet, some do not)."""
    rng = np.random.RandomState(seed)
    b, h = 2, 8
    q, k, v, do = (
        torch.from_numpy(rng.randn(b, h, length, 32).astype(np.float32)).to(dev, dtype)
        for _ in range(4)
    )
    if ids == "runs":
        seg = np.full((b, length), 2, np.int32)
        for i, n in enumerate([int(length * 0.9), length // 3]):
            seg[i, :n] = 1
    elif ids == "random":
        seg = rng.randint(1, 4, (b, length)).astype(np.int32)
    else:
        cycle = np.array([11, -3, 25, 4, 18], np.int32)
        seg = np.stack([cycle[(np.arange(length) // 50 + i) % 5] for i in range(b)])
    return q, k, v, do, torch.from_numpy(seg).to(dev)


@pytest.mark.parametrize(
    "length,dtype,ids",
    [
        (3072, torch.bfloat16, "runs"),
        (700, torch.float32, "runs"),
        (37, torch.bfloat16, "runs"),
        (64, torch.bfloat16, "runs"),
        (700, torch.bfloat16, "runs"),
        (700, torch.bfloat16, "random"),
        (3072, torch.bfloat16, "blocks"),
        (37, torch.float32, "random"),
        (700, torch.float32, "blocks"),
    ],
)
def test_flash_attention_backward_kernels_match_plain(dev, length, dtype, ids):
    q, k, v, do, seg = _attention_inputs(dev, length, dtype, length + 1, ids)
    scale = 32 ** -0.5
    o, lse = flash_attention_cuda(q, k, v, seg, scale, return_lse=True)
    ref_o, ref_lse = attention_plain(q, k, v, seg, scale, return_lse=True)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-4, atol=1e-4)
    di = (o.float() * do.float()).sum(-1)
    before = (flash_attention_dkv_cuda.launches, flash_attention_dq_cuda.launches)
    dk, dv = flash_attention_dkv_cuda(q, k, v, seg, do, lse, di, scale)
    dq = flash_attention_dq_cuda(q, k, v, seg, do, lse, di, scale)
    torch.cuda.synchronize()
    assert (flash_attention_dkv_cuda.launches, flash_attention_dq_cuda.launches) == (
        before[0] + 1, before[1] + 1)
    ref = attention_bwd_plain(q, k, v, seg, do, lse, di, scale)
    # The same roundings (p and ds * scale to the input dtype, then fp32
    # sums) in another order: attention_tol states the bound.
    for name, mine, r in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        assert mine.dtype == dtype
        torch.testing.assert_close(mine.float(), r.float(), **attention_tol(r),
                                   msg=lambda m, n=name: f"{n}: {m}")
    # No atomics: a second launch gives the same bits.
    again = (*flash_attention_dkv_cuda(q, k, v, seg, do, lse, di, scale),
             flash_attention_dq_cuda(q, k, v, seg, do, lse, di, scale))
    for mine, rerun in zip((dk, dv, dq), again):
        assert torch.equal(mine, rerun)


def test_flash_attention_function_on_the_card_matches_cpu(dev):
    q, k, v, do, seg = _attention_inputs(dev, 300, torch.float32, 9)

    def run(device):
        leaves = [x.detach().to(device).requires_grad_(True) for x in (q, k, v)]
        (FlashAttentionFunction.apply(*leaves, seg.to(device), 32 ** -0.5)
         * do.to(device)).sum().backward()
        return [x.grad.cpu() for x in leaves]

    for a, b in zip(run(dev), run("cpu")):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mode", PROBE_MODES)
@pytest.mark.parametrize("cin,cout,dtype", [(32, 32, torch.bfloat16), (96, 96, torch.float32),
                                            (160, 160, torch.bfloat16)])
def test_probe_modes_match_plain(dev, mode, cin, cout, dtype):
    rng = np.random.RandomState(cin + len(mode))
    v, n_valid = 3000, 2711  # ragged: neither is a multiple of the 64-row tile
    nbr = _nbr_table(rng, v, n_valid)
    nbr[640:1024] = v  # six whole tiles with no neighbor: every offset skipped
    nbr = torch.from_numpy(nbr).to(dev)
    feat = torch.from_numpy(rng.randn(v, cin).astype(np.float32)).to(dev, dtype)
    w = torch.from_numpy(
        (rng.randn(27, cin, cout) / np.sqrt(27 * cin)).astype(np.float32)
    ).to(dev, dtype)
    before = dict(probe_conv_cuda.launches)
    out = probe_conv_cuda(mode, feat, nbr, w, n_valid)
    torch.cuda.synchronize()
    assert probe_conv_cuda.launches == dict(before, **{mode: before[mode] + 1})
    ref = probe_conv_plain(mode, feat, nbr, w, n_valid)
    # fp32 sums of the same products in another order (gather_only: the same
    # adds in the same order).
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    assert torch.all(out[n_valid:] == 0)
    if mode != "no_table":
        assert torch.all(out[640:1024] == 0)
    if mode == "full":  # K1's body: K1's bits
        assert torch.equal(out, subm_conv_cuda(feat, nbr, w, n_valid))
    # Deterministic in every mode: a second launch gives the same bits.
    assert torch.equal(out, probe_conv_cuda(mode, feat, nbr, w, n_valid))


def test_wrappers_reject_bad_inputs(dev):
    feat = torch.zeros(10, 8, device=dev)
    nbr = torch.zeros(10, 27, dtype=torch.int64, device=dev)
    w = torch.zeros(27, 8, 4, device=dev)
    with pytest.raises(ValueError):
        subm_conv_cuda(feat, nbr, w, 10)
    with pytest.raises(ValueError):
        subm_conv_dgrad_cuda(torch.zeros(10, 4, device=dev), nbr, w, 10)
    nbr32 = nbr.int()
    with pytest.raises(ValueError):  # grad dtype differs from the features'
        subm_conv_wgrad_cuda(feat, nbr32, torch.zeros(10, 4, device=dev).bfloat16(), 10)
    with pytest.raises(ValueError):  # n_valid past V
        subm_conv_wgrad_cuda(feat, nbr32, torch.zeros(10, 4, device=dev), 11)
    with pytest.raises(ValueError):  # gather_only needs Cin == Cout
        probe_conv_cuda("gather_only", feat, nbr32, w, 10)
    with pytest.raises(ValueError):  # not a mode
        probe_conv_cuda("dma_only", feat, nbr32, torch.zeros(27, 8, 8, device=dev), 10)
    q = torch.zeros(1, 1, 8, 16, device=dev)
    seg = torch.ones(1, 8, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        flash_attention_cuda(q, q, q, seg, 1.0)
    q = torch.zeros(1, 1, 8, 32, device=dev)
    lse = torch.zeros(1, 1, 8, device=dev)
    with pytest.raises(ValueError):  # lse must be fp32
        flash_attention_dkv_cuda(q, q, q, seg, q, lse.half(), lse, 1.0)
    with pytest.raises(ValueError):  # do must match q
        flash_attention_dq_cuda(q, q, q, seg, q.bfloat16(), lse, lse, 1.0)
