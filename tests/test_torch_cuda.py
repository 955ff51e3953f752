"""The port's CUDA kernels against their plain PyTorch versions, on the card:
K1 (conv forward), K1' (conv input gradient), K2 (conv weight gradient), K3
(attention forward, with its logsumexp) and K3-dkv / K3-dq (attention
backward), plus the two autograd Functions against their CPU runs.

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
    flash_attention_cuda,
    flash_attention_dkv_cuda,
    flash_attention_dq_cuda,
)
from unidet3d_tpu_torch.ops.sparse_conv import subm_conv, subm_conv_dgrad, subm_conv_wgrad
from unidet3d_tpu_torch.ops.subm_conv_cuda import (
    SubmConvFunction,
    subm_conv_cuda,
    subm_conv_dgrad_cuda,
    subm_conv_wgrad_cuda,
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
    # Online softmax in fp32 vs a one-pass fp32 softmax; a bf16 output
    # rounds both to 8 bits of mantissa (one bf16 ulp = 2^-8 relative).
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


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
    "cin,cout,dtype",
    [(6, 32, torch.bfloat16), (32, 32, torch.float32), (64, 64, torch.bfloat16),
     (96, 96, torch.float32), (256, 128, torch.bfloat16), (160, 160, torch.bfloat16)],
)
def test_subm_conv_wgrad_kernel_matches_plain(dev, cin, cout, dtype):
    nbr, n_valid, feat, g, _ = _conv_inputs(dev, cin, cout, dtype, cin + cout)
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
    again = subm_conv_wgrad_cuda(feat, nbr, g, n_valid)
    assert torch.equal(out, again)  # no atomics: the same bits every run


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


def _attention_inputs(dev, length, dtype, seed):
    rng = np.random.RandomState(seed)
    b, h = 2, 8
    q, k, v, do = (
        torch.from_numpy(rng.randn(b, h, length, 32).astype(np.float32)).to(dev, dtype)
        for _ in range(4)
    )
    seg = np.full((b, length), 2, np.int32)
    for i, n in enumerate([int(length * 0.9), length // 3]):
        seg[i, :n] = 1
    return q, k, v, do, torch.from_numpy(seg).to(dev)


@pytest.mark.parametrize(
    "length,dtype", [(3072, torch.bfloat16), (700, torch.float32), (37, torch.bfloat16)]
)
def test_flash_attention_backward_kernels_match_plain(dev, length, dtype):
    q, k, v, do, seg = _attention_inputs(dev, length, dtype, length + 1)
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
    # fp32 accumulation of the same products in another order; bf16 outputs
    # round to 8 bits of mantissa (one bf16 ulp = 2^-8 relative).
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
    for name, mine, r in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        assert mine.dtype == dtype
        torch.testing.assert_close(mine.float(), r.float(), rtol=tol, atol=tol, msg=name)


def test_flash_attention_function_on_the_card_matches_cpu(dev):
    q, k, v, do, seg = _attention_inputs(dev, 300, torch.float32, 9)

    def run(device):
        leaves = [x.detach().to(device).requires_grad_(True) for x in (q, k, v)]
        (FlashAttentionFunction.apply(*leaves, seg.to(device), 32 ** -0.5)
         * do.to(device)).sum().backward()
        return [x.grad.cpu() for x in leaves]

    for a, b in zip(run(dev), run("cpu")):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


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
