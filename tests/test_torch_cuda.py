"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (Hopper, sm_90a) and nvcc; elsewhere it
skips. Run on the card from the repository root (the JAX conftest is not
needed and JAX need not be installed):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from unidet3d_tpu_torch.ops.attention import attention_plain, flash_attention_cuda
from unidet3d_tpu_torch.ops.sparse_conv import subm_conv
from unidet3d_tpu_torch.ops.subm_conv_cuda import subm_conv_cuda

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


def test_wrappers_reject_bad_inputs(dev):
    feat = torch.zeros(10, 8, device=dev)
    nbr = torch.zeros(10, 27, dtype=torch.int64, device=dev)
    w = torch.zeros(27, 8, 4, device=dev)
    with pytest.raises(ValueError):
        subm_conv_cuda(feat, nbr, w, 10)
    q = torch.zeros(1, 1, 8, 16, device=dev)
    with pytest.raises(ValueError):
        flash_attention_cuda(q, q, q, torch.ones(1, 8, dtype=torch.int32, device=dev), 1.0)
