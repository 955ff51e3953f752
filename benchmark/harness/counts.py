"""The yardstick's arithmetic: the H100's peaks, and the operations and bytes
that the model's work needs, counted from a batch's own shapes.

Copied from ``chip_smoke.py`` (``conv_shapes``, the per-call bytes and
operations of ``phase_conv`` and ``phase_attention``), with one change:
attention counts the valid query pairs (n^2 per scene and head), the work
these inputs need, not the padded slots' pairs among themselves. Every
bound counts each input read once, each output written once, and the
neighbour pairs present in the level's table, whatever a kernel reads again.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
# Exponentials per clock per SM on the special-function units (sm_90), at an
# assumed 1.98 GHz (the card's maximum SM clock; its clock under load is not
# sampled) over 132 SMs.
SFU_EXP_PER_CLOCK = 16
SM_CLOCK_HZ = 1.98e9  # assumed
SMS = 132
HEAD_DIM = 32

CONV_KERNELS = ("subm_conv_mma_kernel", "subm_conv_wgrad_mma_kernel", "sum_splits_kernel")
ATTN_KERNELS = ("flash_fwd_mma_kernel", "dkv_mma_kernel", "dq_mma_kernel")


class LevelShape(NamedTuple):
    """One U-Net level of a collated batch: its voxel capacity (rows of the
    table), its valid voxels and the valid entries of their 27-neighbour
    table rows."""
    capacity: int
    n_valid: int
    pairs: int


class BatchShape(NamedTuple):
    """What the counts need of one forward: the levels and, per scene, its
    valid queries."""
    levels: tuple  # LevelShape per level
    queries: tuple  # valid queries per scene


def conv_shapes(planes: Sequence[int]) -> dict:
    """{(level, cin, cout): calls per forward} of the 37 submanifold convs."""
    shapes = {(0, 6, planes[0]): 1}  # input conv
    for lvl, c in enumerate(planes):
        shapes[(lvl, c, c)] = shapes.get((lvl, c, c), 0) + 4  # 2 pre-blocks
        if lvl < len(planes) - 1:
            shapes[(lvl, 2 * c, c)] = 1  # first tail block, conv1
            shapes[(lvl, c, c)] += 3  # its conv2 + the second tail block
    return shapes


def _bound_s(nbytes: float, ops: float, exps: float = 0.0) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / BF16_FLOPS,
               exps / (SMS * SFU_EXP_PER_CLOCK * SM_CLOCK_HZ))


def conv_bound_s(shape: BatchShape, planes: Sequence[int], train: bool) -> float:
    """Seconds the subm convs of one forward (with `train`, also their input
    and weight gradients: K1', K2) need at least on the card, bf16 inputs."""
    total = 0.0
    for (lvl, cin, cout), calls in conv_shapes(planes).items():
        lv = shape.levels[lvl]
        n, v, pairs = lv.n_valid, lv.capacity, lv.pairs
        ops = 2.0 * pairs * cin * cout
        table = n * 27 * 4
        total += calls * _bound_s(table + n * cin * 2 + 27 * cin * cout * 2 + v * cout * 4, ops)
        if train:
            dgrad_calls = calls - (1 if cin == 6 else 0)  # the input conv's input is data
            total += dgrad_calls * _bound_s(
                table + n * cout * 2 + 27 * cin * cout * 2 + v * cin * 4, ops)
            total += calls * _bound_s(
                table + n * cin * 2 + n * cout * 2 + 27 * cin * cout * 4, ops)
    return total


def attn_bound_s(shape: BatchShape, slots: int, num_heads: int, num_layers: int,
                 train: bool) -> float:
    """Seconds the decoder's attention calls of one forward (with `train`,
    also K3-dkv and K3-dq) need at least: per valid query pair and head the
    products each output needs (forward q k and p v; dkv s, dp, dv, dk; dq
    s, dp, dq) and one exp, against the bytes of q, k, v, o (and do, lse,
    di, dq / dk / dv) over all `slots` padded rows."""
    b, hd = len(shape.queries), HEAD_DIM
    pairs = sum(n * n for n in shape.queries) * num_heads
    bhs = b * num_heads * slots
    seg = b * slots * 4
    work = [(2, 4 * bhs * hd * 2 + (bhs * 4 if train else 0) + seg)]
    if train:
        work += [(4, 6 * bhs * hd * 2 + 2 * bhs * 4 + seg),
                 (3, 5 * bhs * hd * 2 + 2 * bhs * 4 + seg)]
    return num_layers * sum(_bound_s(nbytes, 2.0 * products * pairs * hd, pairs)
                            for products, nbytes in work)


def model_flops(shape: BatchShape, planes: Sequence[int], d_model: int, num_heads: int,
                hidden: int, num_layers: int, n_classes: int, train: bool) -> float:
    """Multiply-adds x 2 that one forward of the model needs on these inputs
    (training: the forward, the input gradients and the weight gradients,
    three times the forward but for the input conv's input gradient). The
    matcher computes its costs elementwise (no products) and is not
    counted; normalisations, activations and reductions are not counted."""
    lv = shape.levels
    subm = sum(calls * 2.0 * lv[lvl].pairs * cin * cout
               for (lvl, cin, cout), calls in conv_shapes(planes).items())
    input_conv = 2.0 * lv[0].pairs * 6 * planes[0]
    dense = 0.0
    for lvl in range(len(planes) - 1):
        c, c2 = planes[lvl], planes[lvl + 1]
        dense += 2.0 * lv[lvl].n_valid * c * c2  # strided conv: one W[o] per fine voxel
        dense += 2.0 * lv[lvl].n_valid * c2 * c  # inverse conv: one W[o] per fine voxel
        dense += 2.0 * lv[lvl].n_valid * 2 * c * c  # the first tail block's 1x1 branch
    q = float(sum(shape.queries))
    pairs = float(sum(n * n for n in shape.queries))
    hd = d_model // num_heads
    proj = 2.0 * q * (planes[0] * d_model + d_model * d_model)
    layer = (2.0 * q * 4 * d_model * d_model  # q, k, v, out projections
             + 2.0 * 2 * pairs * hd * num_heads  # q k^T and p v
             + 2.0 * q * 2 * d_model * hidden)  # the FFN
    heads = (num_layers + 1) * 2.0 * q * (d_model * d_model + d_model * n_classes + d_model * 8)
    forward = subm + dense + proj + num_layers * layer + heads
    if not train:
        return forward
    return 3.0 * forward - input_conv


def pairs_of(neighbors, n_valid: int) -> int:
    """Valid entries of the first n_valid rows of a (V, 27) table whose
    sentinel is V (numpy or torch)."""
    rows = neighbors[:n_valid]
    return int((rows < neighbors.shape[0]).sum())
