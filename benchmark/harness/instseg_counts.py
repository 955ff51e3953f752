"""OneFormer3D's operations and bytes, counted from a forward's own shapes:
the mask attention's bound (M1, ``mask_attn_roofline``) and the whole
forward's model operations (``instseg_forward_mfu``).

What attention must do whatever implements it: per open (query, key) pair
of a valid row, q k and p v over d_model (4 x d_model operations over the
heads) and one exp per head; q, k, v and o read or written once for the
valid rows (bf16), the bitmask's words once. The H100's peaks are
``counts.py``'s.
"""
from __future__ import annotations

from typing import NamedTuple

from . import counts

M1_KERNELS = ("mask_attention_mma_kernel",)


class InstsegShape(NamedTuple):
    """One traced forward: the backbone's levels, each scene's valid
    superpoints, and each layer's open (query, key) pairs of valid rows
    over the group."""
    levels: tuple  # counts.LevelShape per U-Net level
    superpoints: tuple  # valid superpoints per scene
    open_pairs: tuple  # per decoder layer


def mask_attn_bound_s(shape: InstsegShape, d_model: int, num_heads: int, n_sem: int) -> float:
    """Seconds the forward's M1 launches need at least on the card."""
    total = 0.0
    for pairs in shape.open_pairs:
        ops = 4.0 * d_model * pairs
        exps = float(num_heads) * pairs
        nbytes = 0.0
        for n in shape.superpoints:
            q_rows = n_sem + n
            nbytes += 2 * q_rows * d_model * 2  # q in, o out, bf16
            nbytes += 2 * n * d_model * 2  # k, v
            nbytes += q_rows * -(-n // 32) * 4  # the bitmask
        total += counts._bound_s(nbytes, ops, exps)
    return total


def forward_flops(shape: InstsegShape, planes, d_model: int, num_heads: int, hidden: int,
                  num_layers: int, n_sem: int, n_classes: int) -> float:
    """Multiply-adds x 2 of one forward on these inputs: the backbone (the
    37 subm convs, the strided and inverse convs and 1x1 branches, as
    ``counts.model_flops``), the decoder's input projections, per layer the
    cross-attention (projections and its open pairs), the self-attention
    (projections and every valid pair), the FFN, and the L + 1 heads (class
    MLP and the mask product over the scene's superpoints)."""
    backbone = counts.model_flops(counts.BatchShape(shape.levels, ()), planes, d_model,
                                  num_heads, hidden, 0, n_classes, False)
    c0, d = planes[0], d_model
    total = backbone
    for n in shape.superpoints:
        q = n_sem + n
        total += 2.0 * n * (c0 * d + 2 * (c0 * d + d * d))  # input_proj, query_proj, x_mask
        layer = (2.0 * q * 2 * d * d + 2.0 * n * 2 * d * d  # cross: q, out; k, v
                 + 2.0 * q * 4 * d * d + 4.0 * d * q * q  # self: projections, pairs
                 + 2.0 * q * 2 * d * hidden)  # FFN
        total += num_layers * layer
        total += (num_layers + 1) * 2.0 * q * (d * d + d * (n_classes + 1) + n * d)
    total += 4.0 * d * sum(shape.open_pairs)  # the cross-attention's open pairs
    return total
