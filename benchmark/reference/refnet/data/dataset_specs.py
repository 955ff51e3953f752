"""Per-dataset label remaps (raw info label id -> contiguous class index).

The port's own copy of the JAX package's ``data/dataset_specs.py``.

Mirror of the reference datasets' `valid_class_ids` filtering
(multiscan_dataset.py:78,101; rscan_dataset.py:77,99;
scannetpp_dataset.py:87-95,116): instances whose raw label is not listed are
dropped; the rest are renumbered by list position. ScanNet / S3DIS /
ARKitScenes infos already carry contiguous labels (no remap).
"""
from __future__ import annotations

# ScanNet nyu40 taxonomy (ref data/scannet/batch_load_scannet_data.py:25-26,
# tools/scannet_data_utils.py:101-103): 20 segmentation classes (incl. the
# wall/floor stuff classes) and the 18 detection classes. Semantic .bin files
# store raw nyu40 ids; `point_seg_class_mapping` converts to train ids 0..19
# (unmapped -> 20 = ignore), and detection labels are the position of the
# instance's nyu40 id in SCANNET_DET_CAT_IDS.
SCANNET_SEG_VALID_CLASS_IDS = (
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36, 39,
)
SCANNET_DET_CAT_IDS = (
    3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36, 39,
)

MULTISCAN_VALID_CLASS_IDS = tuple(range(3, 20))

RSCAN_VALID_CLASS_IDS = (
    3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36, 39,
)

SCANNETPP_VALID_CLASS_IDS = (
    3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 17, 18,
    21, 22, 23, 25, 27, 28, 29, 30, 31, 32, 34, 35, 37,
    38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 49, 50, 51,
    52, 54, 55, 56, 57, 58, 59, 60, 61, 62, 65, 66, 67,
    68, 69, 70, 71, 72, 75, 76, 77, 78, 79, 80, 81, 82,
    83, 84, 85, 86, 87, 88, 89, 90, 91, 92, 93, 94, 95,
    96, 97, 98, 99,
)


def _mapping(valid_ids):
    return {int(c): i for i, c in enumerate(valid_ids)}


DEFAULT_LABEL_MAPPINGS = {
    "scannet": None,
    "s3dis": None,
    "multiscan": _mapping(MULTISCAN_VALID_CLASS_IDS),
    "3rscan": _mapping(RSCAN_VALID_CLASS_IDS),
    "scannetpp": _mapping(SCANNETPP_VALID_CLASS_IDS),
    "arkitscenes": None,
}
