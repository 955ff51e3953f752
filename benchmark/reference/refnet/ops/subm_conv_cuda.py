"""The submanifold conv of the reference: the port's plain versions
(``ops/sparse_conv.py``) with their own backward, no kernel."""
from __future__ import annotations

import torch

from ..precision import rnd
from .sparse_conv import subm_conv, subm_conv_dgrad, subm_conv_wgrad


class SubmConvFunction(torch.autograd.Function):
    """out = subm_conv(features, neighbors, weight); the backward is the
    plain input and weight gradients, with the cotangent rounded as the
    features are."""

    @staticmethod
    def forward(ctx, features, neighbors, weight, n_valid: int):
        w = rnd(weight).contiguous()
        ctx.save_for_backward(features, neighbors, w)
        ctx.n_valid = int(n_valid)
        return subm_conv(features, neighbors, w, n_valid)

    @staticmethod
    def backward(ctx, grad_out):
        features, neighbors, w = ctx.saved_tensors
        g = rnd(grad_out).contiguous()
        dfeat = dw = None
        if ctx.needs_input_grad[0]:
            dfeat = subm_conv_dgrad(g, neighbors, w, ctx.n_valid)
        if ctx.needs_input_grad[2]:
            dw = subm_conv_wgrad(features, neighbors, g, ctx.n_valid)
        return dfeat, None, dw, None
