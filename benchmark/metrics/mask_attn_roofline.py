"""M1's bound seconds (the traced forwards' mask attention,
harness/instseg_counts.py::mask_attn_bound_s, from each forward's open
pairs) over the device seconds of its kernel, taken by name from the trace,
in %."""
from benchmark.harness import instseg_counts
from benchmark.harness.trace import device_seconds

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"


def read(record):
    tr, shapes = record.get("trace"), record.get("instseg_shapes")
    if not tr or not shapes:
        return None
    d = record["dims"]
    spent = device_seconds(tr["kernel_s"], instseg_counts.M1_KERNELS)
    if spent <= 0:
        return None
    bound = sum(instseg_counts.mask_attn_bound_s(s, d["d_model"], d["num_heads"], d["n_sem"])
                for s in shapes)
    return 100.0 * bound / spent
