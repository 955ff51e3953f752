"""What the per-layer readers in ``benchmark/metrics/`` share: each reads
the traced run's record and returns a number, or None where it finds
nothing to read (no trace, no device time of its kernels), so that the
harness leaves the metric out of the line."""
from __future__ import annotations

import statistics

from . import counts
from .trace import device_seconds


def mean_ms(values):
    return statistics.mean(values) * 1e3 if values else None


def idle_share(record):
    """100 x (1 - the device's busy seconds / the traced slice's seconds)."""
    tr = record.get("trace")
    if not tr or tr["busy_s"] <= 0 or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def mfu(record):
    """100 x the model operations of the traced slice's steps or forwards
    over (its seconds x the bf16 peak)."""
    tr, shapes = record.get("trace"), record.get("traced_shapes")
    if not tr or not shapes or tr["window_s"] <= 0:
        return None
    d = record["dims"]
    ops = sum(counts.model_flops(shape, d["planes"], d["d_model"], d["num_heads"], d["hidden"],
                                 d["num_layers"], d["n_classes"], record["train"])
              for shape, _ in shapes)
    return 100.0 * ops / (tr["window_s"] * counts.BF16_FLOPS)


def roofline(record, kind: str):
    """100 x the bound seconds of the traced slice's conv or attention work
    over the device seconds of the kernels that did it."""
    tr, shapes = record.get("trace"), record.get("traced_shapes")
    if not tr or not shapes:
        return None
    d = record["dims"]
    if kind == "conv":
        bound = sum(counts.conv_bound_s(shape, d["planes"], record["train"]) for shape, _ in shapes)
        spent = device_seconds(tr["kernel_s"], counts.CONV_KERNELS)
    else:
        bound = sum(counts.attn_bound_s(shape, slots, d["num_heads"], d["num_layers"],
                                        record["train"]) for shape, slots in shapes)
        spent = device_seconds(tr["kernel_s"], counts.ATTN_KERNELS)
    if spent <= 0:
        return None
    return 100.0 * bound / spent
