"""The port's attention backward against the TPU flash attention's own
backward kernels (``_flash_attention_bwd_dkv``, ``_flash_attention_bwd_dq``
of ``jax.experimental.pallas.ops.tpu.flash_attention``), run on the CPU in
TPU interpret mode, in bf16; the card checks' tolerance (``attention_tol``)
against a backward with a fault; and the ptxas report the card run prints
for the kernels.

The TPU kernels round p to bf16 before the dv product and ds * sm_scale
before the dk and dq products; ``attention_bwd_plain`` rounds at the same
points, which is what the Hopper kernels are held to on the card. Inputs come
from numpy seeds and go through both packages.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu.flash_attention import SegmentIds, flash_attention

from unidet3d_tpu_torch.ops.attention import (
    _masked_logits,
    attention_bwd_plain,
    attention_plain,
    attention_tol,
)
from unidet3d_tpu_torch.ops.cuda_build import ptxas_report

SCALE = 32 ** -0.5
BF16_ULP = 2.0 ** -8  # relative spacing of bf16 values at a power of two


def _inputs(b, length, ids, seed):
    """q, k, v, do (b, 2, length, 32) fp32 and (b, length) int32 ids: "runs"
    as the decoder's (valid rows 1, padded rows 2; the run lengths of
    tests/test_torch_cuda.py::_attention_inputs), "random" ids in {1, 2, 3}."""
    rng = np.random.RandomState(seed)
    q, k, v, do = (rng.randn(b, 2, length, 32).astype(np.float32) for _ in range(4))
    if ids == "runs":
        seg = np.full((b, length), 2, np.int32)
        for i, n in enumerate([int(length * 0.9), length // 3][:b]):
            seg[i, :n] = 1
    else:
        seg = rng.randint(1, 4, (b, length)).astype(np.int32)
    return q, k, v, do, seg


def _tpu_backward(q, k, v, do, seg):
    """o and (dq, dk, dv) of the TPU flash attention (128-blocks), bf16, in
    interpret mode; as fp32 numpy arrays."""
    ids = SegmentIds(jnp.asarray(seg), jnp.asarray(seg))
    with pltpu.force_tpu_interpret_mode():
        o, vjp = jax.vjp(
            lambda q_, k_, v_: flash_attention(q_, k_, v_, segment_ids=ids, sm_scale=SCALE),
            *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
        grads = vjp(jnp.asarray(do, jnp.bfloat16))
    return [np.array(x.astype(jnp.float32)) for x in (o, *grads)]


def _rel(mine, ref):
    return (torch.linalg.norm(mine.float() - ref) / torch.linalg.norm(ref)).item()


@pytest.mark.parametrize("b,ids", [(1, "runs"), (2, "runs"), (2, "random")])
def test_plain_backward_matches_tpu_kernel(b, ids):
    q, k, v, do, seg = _inputs(b, 256, ids, seed=b + len(ids))
    tpu_o, *tpu = _tpu_backward(q, k, v, do, seg)
    tpu = [torch.from_numpy(x) for x in tpu]
    tq, tk, tv, tdo = (torch.from_numpy(x).bfloat16() for x in (q, k, v, do))
    tseg = torch.from_numpy(seg)

    # The port end to end: its own forward (o, lse), di, the bf16 backward.
    # Each side rounds o to bf16 and the two may land one ulp apart; that
    # moves di and with it every ds of the row, so the gradients agree
    # within one bf16 ulp in norm, not per element.
    o, lse = attention_plain(tq, tk, tv, tseg, SCALE, return_lse=True)
    own = attention_bwd_plain(tq, tk, tv, tseg, tdo, lse, (o.float() * tdo.float()).sum(-1),
                              SCALE)
    for name, mine, ref in zip(("dq", "dk", "dv"), own, tpu):
        assert mine.dtype == torch.bfloat16
        assert _rel(mine, ref) < BF16_ULP, name

    # From the TPU kernel's own o (the same di): the bf16 backward rounds
    # where the TPU kernels round, so what is left are fp32 sums in another
    # order and the rare p or ds that lands one ulp apart: within one bf16
    # ulp of the largest value per element, and 2^-11 in norm. fp32
    # throughout (today's card fp32 route, and the port's plain backward
    # before the rounding was matched) is at least 10x further off.
    di = (torch.from_numpy(tpu_o) * tdo.float()).sum(-1)
    matched = attention_bwd_plain(tq, tk, tv, tseg, tdo, lse, di, SCALE)
    fp32 = attention_bwd_plain(tq.float(), tk.float(), tv.float(), tseg, tdo.float(),
                               lse, di, SCALE)
    for name, mine, full, ref in zip(("dq", "dk", "dv"), matched, fp32, tpu):
        torch.testing.assert_close(mine.float(), ref, rtol=0,
                                   atol=2 * BF16_ULP * ref.abs().max().item(), msg=name)
        assert _rel(mine, ref) < 2.0 ** -11, name
        assert 10 * _rel(mine, ref) < _rel(full, ref), name


def _bwd(q, k, v, seg, do, lse, di, mask=True, scale_ds=True):
    """The bf16 backward written out once more, with a fault to choose: the
    segment mask dropped, or sm_scale left out of ds."""
    logits = _masked_logits(q, k, seg if mask else torch.ones_like(seg), SCALE)
    p = torch.exp(logits - lse[..., None])
    dv = torch.einsum("bhqk,bhqd->bhkd", p.bfloat16().float(), do.float())
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
    ds = (p * (dp - di[..., None]) * (SCALE if scale_ds else 1.0)).bfloat16().float()
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    return dq.bfloat16(), dk.bfloat16(), dv.bfloat16()


@pytest.mark.parametrize("fault", ["none", "mask dropped", "scale left out"])
def test_attention_tol_rejects_a_faulty_backward(fault):
    q, k, v, do, seg = (torch.from_numpy(x) for x in _inputs(2, 256, "runs", seed=4))
    q, k, v, do = (x.bfloat16() for x in (q, k, v, do))
    o, lse = attention_plain(q, k, v, seg, SCALE, return_lse=True)
    di = (o.float() * do.float()).sum(-1)
    ref = attention_bwd_plain(q, k, v, seg, do, lse, di, SCALE)
    mine = _bwd(q, k, v, seg, do, lse, di, mask=fault != "mask dropped",
                scale_ds=fault != "scale left out")
    if fault == "none":
        for a, r in zip(mine, ref):
            assert torch.equal(a, r)
        return
    # A fault moves dq and dk (the mask also dv) far past the tolerance.
    rejected = 0
    for a, r in zip(mine, ref):
        try:
            torch.testing.assert_close(a.float(), r.float(), **attention_tol(r))
        except AssertionError:
            rejected += 1
    assert rejected == (3 if fault == "mask dropped" else 2)


def test_attention_tol_by_dtype():
    ref = torch.tensor([[0.5, -2.0]])
    assert attention_tol(ref) == dict(rtol=1e-4, atol=1e-4)
    assert attention_tol(ref.bfloat16()) == dict(rtol=2.0 ** -7, atol=2.0 ** -7)


def test_ptxas_report_reads_each_kernel():
    """The registers, spills and shared memory that chip_smoke.py prints for
    the tensor-core kernels (the backward pair, the forward, the conv), from
    nvcc's -Xptxas -v output (CUDA 12.8's format, with the hashed anonymous
    namespace)."""
    log = "\n".join([
        "ptxas info    : 0 bytes gmem",
        "ptxas info    : Compiling entry function '_ZN49_GLOBAL__N__844ed71a_16_attention"
        "_bwd_cu_9d30030a13dq_mma_kernelEPK13__nv_bfloat16S2_S2_PKiS2_PKfS6_PS0_iif' for "
        "'sm_90a'",
        "ptxas info    : Function properties for _ZN49_GLOBAL__N__844ed71a_16_attention_bwd"
        "_cu_9d30030a13dq_mma_kernelEPK13__nv_bfloat16S2_S2_PKiS2_PKfS6_PS0_iif",
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 125 registers, used 1 barriers, 20992 bytes smem, 440 bytes "
        "cmem[0]",
        "ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__4700c0e1_12_subm_conv_cu"
        "_a78a8cb516subm_conv_kernelIfLi4ELi3EEEvPKT_PKiS3_Pfiiii' for 'sm_90a'",
        "ptxas info    : Used 48 registers, used 1 barriers, 16768 bytes smem",
        "ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__3b1f2c07_12_attention_cu"
        "_5e0d9a1120flash_fwd_mma_kernelEPK13__nv_bfloat16S2_S2_PKiPS0_Pfiif' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN45_GLOBAL__N__3b1f2c07_12_attention_cu"
        "_5e0d9a1120flash_fwd_mma_kernelEPK13__nv_bfloat16S2_S2_PKiPS0_Pfiif",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 96 registers, used 1 barriers, 20992 bytes smem, 400 bytes "
        "cmem[0]",
        "ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__4700c0e1_12_subm_conv_cu"
        "_a78a8cb520subm_conv_mma_kernelILi160ELi0EEEvPK13__nv_bfloat16PKiS3_Pfiiiiii' for "
        "'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers, 428 bytes cmem[0]",
    ])
    assert ptxas_report(log) == [
        ("dq_mma_kernel", dict(spill_stores=8, spill_loads=4, registers=125, smem=20992)),
        ("subm_conv_kernel", dict(registers=48, smem=16768)),
        ("flash_fwd_mma_kernel", dict(spill_stores=0, spill_loads=0, registers=96,
                                      smem=20992)),
        # A template over integers keeps its arguments (the conv's column
        # width and probe mode); its shared memory is dynamic only, so ptxas
        # reports none.
        ("subm_conv_mma_kernel<160, 0>",
         dict(spill_stores=0, spill_loads=0, registers=168)),
    ]
