"""The port's attention forward against the TPU flash attention's own forward
kernel (``jax.experimental.pallas.ops.tpu.flash_attention``), run on the CPU
in TPU interpret mode, in bf16; the card checks' tolerance (``attention_tol``)
against a forward with a fault; and the host side of the conv kernel's block
shape (``conv_tile``) at every conv shape of the production model.

The TPU forward rounds the unnormalised p to bf16 before the p v product
(``flash_attention.py:470-471``) and sums the unrounded fp32 p into l;
``attention_plain`` rounds at the same point, which is what the Hopper
forward is held to on the card. Inputs come from numpy seeds and go through
both packages.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu.flash_attention import SegmentIds, flash_attention

from unidet3d_tpu_torch.core.config import default_config
from unidet3d_tpu_torch.ops.attention import _masked_logits, attention_plain, attention_tol
from unidet3d_tpu_torch.ops.subm_conv_cuda import conv_tile

SCALE = 32 ** -0.5
SMEM_LIMIT = 232448  # shared memory one block can use on the H100 (227 KB)


def _inputs(b, length, ids, seed):
    """q, k, v (b, 2, length, 32) fp32 and (b, length) int32 ids: "runs" as
    the decoder's (valid rows 1, padded rows 2), "random" ids in {1, 2, 3}."""
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, 2, length, 32).astype(np.float32) for _ in range(3))
    if ids == "runs":
        seg = np.full((b, length), 2, np.int32)
        for i, n in enumerate([int(length * 0.9), length // 3][:b]):
            seg[i, :n] = 1
    else:
        seg = rng.randint(1, 4, (b, length)).astype(np.int32)
    return q, k, v, seg


def _tpu_forward(q, k, v, seg):
    """o of the TPU flash attention (128-blocks), bf16, in interpret mode,
    as an fp32 tensor."""
    ids = SegmentIds(jnp.asarray(seg), jnp.asarray(seg))
    with pltpu.force_tpu_interpret_mode():
        o = flash_attention(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                            segment_ids=ids, sm_scale=SCALE)
    return torch.from_numpy(np.array(o.astype(jnp.float32)))


def _rel(mine, ref):
    return (torch.linalg.norm(mine.float() - ref) / torch.linalg.norm(ref)).item()


def _ulp(x: float) -> float:
    """The spacing of bf16 values at |x| (8 bits of mantissa)."""
    return 2.0 ** (np.floor(np.log2(abs(x))) - 7)


@pytest.mark.parametrize("b,ids", [(1, "runs"), (2, "runs"), (2, "random")])
def test_plain_forward_matches_tpu_kernel(b, ids):
    q, k, v, seg = _inputs(b, 256, ids, seed=b + len(ids))
    tpu = _tpu_forward(q, k, v, seg)
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    tseg = torch.from_numpy(seg)
    mine = attention_plain(tq, tk, tv, tseg, SCALE)
    assert mine.dtype == torch.bfloat16
    # Both round p to bf16 before the product; the TPU relative to its
    # running max over 128-key blocks, the plain version relative to the row
    # max, so where a row's max comes in a later block the two round p apart
    # and o moves by ~2^-10 of its scale: within one bf16 ulp of the largest
    # value per element, 2^-9 in norm (measured 1.1e-3 to 1.5e-3), and
    # inside the card's bf16 bound.
    worst = tpu.abs().max().item()
    torch.testing.assert_close(mine.float(), tpu, rtol=0, atol=_ulp(worst))
    assert _rel(mine, tpu) < 2.0 ** -9
    torch.testing.assert_close(mine.float(), tpu, **attention_tol(tpu.bfloat16()))
    # fp32 throughout (the card's fp32 route, and the port's plain forward
    # before the rounding was matched), rounded once to bf16, is further
    # off: 1.47x to 2.05x in norm on these inputs, over 2^-9.
    fp32 = attention_plain(tq.float(), tk.float(), tv.float(), tseg, SCALE).bfloat16()
    assert _rel(fp32, tpu) > 1.3 * _rel(mine, tpu)
    assert _rel(fp32, tpu) > 2.0 ** -9


def test_plain_forward_rounding_is_the_identity_in_fp32():
    q, k, v, seg = (torch.from_numpy(x) for x in _inputs(2, 96, "random", seed=7))
    logits = _masked_logits(q, k, seg, SCALE)
    ref = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(logits, -1), v)
    o, lse = attention_plain(q, k, v, seg, SCALE, return_lse=True)
    # The same fp32 softmax, normalised after the product instead of before.
    torch.testing.assert_close(o, ref, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(lse, torch.logsumexp(logits, -1), rtol=0, atol=0)


def _fwd(q, k, v, seg, mask=True, scale=True):
    """The bf16 forward written out once more, with a fault to choose: the
    segment mask dropped, or sm_scale left out."""
    logits = _masked_logits(q, k, seg if mask else torch.ones_like(seg),
                            SCALE if scale else 1.0)
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    out = torch.einsum("bhqk,bhkd->bhqd", p.bfloat16().float(), v.float())
    return (out / p.sum(-1, keepdim=True)).bfloat16()


@pytest.mark.parametrize("fault", ["none", "mask dropped", "scale left out"])
def test_attention_tol_rejects_a_faulty_forward(fault):
    q, k, v, seg = (torch.from_numpy(x) for x in _inputs(2, 256, "runs", seed=4))
    q, k, v = (x.bfloat16() for x in (q, k, v))
    ref = attention_plain(q, k, v, seg, SCALE)
    mine = _fwd(q, k, v, seg, mask=fault != "mask dropped", scale=fault != "scale left out")
    if fault == "none":
        assert torch.equal(mine, ref)
        return
    with pytest.raises(AssertionError):
        torch.testing.assert_close(mine.float(), ref.float(), **attention_tol(ref))


def _conv_shapes(planes):
    """{(cin, cout): convs} of the 37 forward convs and the 36 input
    gradients (K1 on mirrored weights: Cin and Cout swapped; none for the
    input conv), as chip_smoke.py::conv_shapes counts the forward's."""
    fwd = {(6, planes[0]): 1}
    for lvl, c in enumerate(planes):
        fwd[(c, c)] = fwd.get((c, c), 0) + 4
        if lvl < len(planes) - 1:
            fwd[(2 * c, c)] = 1
            fwd[(c, c)] += 3
    dgrad = {(cout, cin): n for (cin, cout), n in fwd.items() if cin != 6}
    return fwd, dgrad


def test_conv_tile_fits_every_conv_of_the_model():
    fwd, dgrad = _conv_shapes(default_config().num_planes)
    assert sum(fwd.values()) == 37 and sum(dgrad.values()) == 36
    # The widest input gradient is the level-3 tail's 128 -> 256; Cout 320
    # (a 160-channel level's tail) is checked too.
    assert (6, 32) in fwd and max(cout for _, cout in dgrad) == 256
    for cin, cout in [*fwd, *dgrad, (160, 320)]:
        tile = conv_tile(cout)
        blocks = -(-cout // tile.cols)
        # 16 rows per warp, column blocks of equal width that cover Cout with
        # less than one 32-column slice to spare, at most 160 wide (80 fp32
        # accumulators a thread).
        assert tile.rows == 16 * tile.warps == 64
        assert tile.cols % 32 == 0 and tile.cols <= 160
        assert blocks * tile.cols - cout < 32
        assert tile.smem <= SMEM_LIMIT // 3, (cin, cout, tile)  # 3 blocks per SM
    # The widths the kernel is compiled for, and the largest block's memory.
    assert {conv_tile(c).cols for _, c in [*fwd, *dgrad, (160, 320)]} == {
        32, 64, 96, 128, 160}
    assert conv_tile(320).smem == conv_tile(160).smem == 70632
    assert conv_tile(6) == conv_tile(32)
