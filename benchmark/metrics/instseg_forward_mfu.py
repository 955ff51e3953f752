"""OneFormer3D's forwards' model operations in the traced pass (the
backbone, both attentions, the projections, the FFN, the 7 mask products
and the heads, harness/instseg_counts.py::forward_flops) over the traced
slice's wall time x 989 TFLOP/s (bf16 peak), in %."""
from benchmark.harness import counts, instseg_counts

LAYER = "step / device"
UNIT = "%"
SOURCE = "host_clock"


def read(record):
    tr, shapes = record.get("trace"), record.get("instseg_shapes")
    if not tr or not shapes or tr["window_s"] <= 0:
        return None
    d = record["dims"]
    ops = sum(instseg_counts.forward_flops(s, d["planes"], d["d_model"], d["num_heads"],
                                           d["hidden"], d["num_layers"], d["n_sem"],
                                           d["n_classes"]) for s in shapes)
    return 100.0 * ops / (tr["window_s"] * counts.BF16_FLOPS)
