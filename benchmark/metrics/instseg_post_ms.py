"""OneFormer3D's instance post-processing (top-k, object normalization,
matrix NMS, thresholds: the program's span "post.masks") in ms per group,
over the traced pass's groups."""
LAYER = "post-processing"
UNIT = "ms"
SOURCE = "program_span"


def read(record):
    post = record.get("post_masks_s")
    return 1e3 * sum(post) / len(post) if post else None
