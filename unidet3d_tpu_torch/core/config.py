"""Typed configuration for the PyTorch/CUDA port of UniDet3D.

The same experiment surface as the JAX package's ``core/config.py``:
per-dataset behaviour flags are parallel lists indexed by dataset id, plus the
static capacity knobs that size the padded batch. The TPU-only fields of the
JAX config (banded conv windows, miss-list caps, pack alignment, the subm
implementation switch, the mesh axis) have no meaning on the GPU and are not
carried.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # Reference model hyper-parameters.
    in_channels: int = 6
    num_channels: int = 32
    voxel_size: float = 0.02
    min_spatial_shape: int = 128
    query_thr: int = 3000
    num_planes: Tuple[int, ...] = (32, 64, 96, 128, 160)
    # Decoder.
    num_layers: int = 6
    d_model: int = 256
    num_heads: int = 8
    hidden_dim: int = 1024
    dropout: float = 0.0
    activation: str = "gelu"
    # Datasets (parallel lists).
    datasets: Tuple[str, ...] = (
        "scannet",
        "s3dis",
        "multiscan",
        "3rscan",
        "scannetpp",
        "arkitscenes",
    )
    bbox_by_mask: Tuple[bool, ...] = (True, True, False, False, False, False)
    target_by_distance: Tuple[bool, ...] = (False, False, True, True, True, True)
    use_superpoints: Tuple[bool, ...] = (True, True, True, False, False, False)
    fast_nms: Tuple[bool, ...] = (True, False, True, True, True, True)
    angles: Tuple[bool, ...] = (False, False, False, False, False, True)
    # Criterion.
    datasets_weights: Tuple[float, ...] = (1.0,) * 6
    topk: Tuple[int, ...] = (6, 6, 3, 3, 3, 3)
    loss_weight: Tuple[float, float] = (0.5, 1.0)
    non_object_weight: float = 0.1
    train_topk_targets: int = 6
    # Test cfg.
    low_sp_thr: float = 0.18
    up_sp_thr: float = 0.81
    topk_insts: int = 1000
    score_thr: float = 0.0
    iou_thr: Tuple[float, ...] = (0.5, 0.55, 0.55, 0.55, 0.55, 0.55)
    # Static capacities: the padded batch shapes.
    max_points: int = 196608  # per scene point cap P
    voxel_capacity: int = 163840  # level-0 voxel cap PER SCENE
    max_superpoints: int = 3072  # per scene superpoint cap S
    max_gts: int = 128  # per scene GT cap G
    # Backbone and decoder compute dtype: 'float32' or 'bfloat16'
    # (accumulation stays fp32 either way).
    compute_dtype: str = "bfloat16"

    @property
    def num_datasets(self) -> int:
        return len(self.datasets)

    def level_capacities(self, batch_size: int) -> Tuple[int, ...]:
        """Voxel capacity per U-Net level for a batch of `batch_size` scenes.

        voxel_capacity is PER SCENE; each level halves with a per-scene floor
        of 1024."""
        caps = [self.voxel_capacity]
        for _ in range(len(self.num_planes) - 1):
            caps.append(max(caps[-1] // 2, 1024))
        return tuple(c * batch_size for c in caps)


@dataclasses.dataclass(frozen=True)
class OneFormer3DConfig:
    """OneFormer3D's ScanNet instance segmentation (configs/
    oneformer3d_1xb4_scannet.py of github.com/filapro/oneformer3d), at
    inference. The backbone and the static capacities are UniDet3D's
    (``ModelConfig``'s names, read by the same data path); the decoder and
    ``test_cfg`` are the public config's."""

    in_channels: int = 6
    num_channels: int = 32
    voxel_size: float = 0.02
    min_spatial_shape: int = 128
    num_planes: Tuple[int, ...] = (32, 64, 96, 128, 160)
    # Decoder (ScanNetQueryDecoder): every superpoint is an instance query,
    # plus the semantic queries; iter_pred and attn_mask.
    num_layers: int = 6
    d_model: int = 256
    num_heads: int = 8
    hidden_dim: int = 1024
    dropout: float = 0.0
    activation: str = "gelu"
    num_semantic_queries: int = 20
    num_instance_classes: int = 18
    num_semantic_classes: int = 20
    datasets: Tuple[str, ...] = ("scannet",)
    # test_cfg.
    topk_insts: int = 600
    inst_score_thr: float = 0.0
    npoint_thr: int = 100
    obj_normalization: bool = True
    sp_score_thr: float = 0.4
    nms: bool = True
    matrix_nms_kernel: str = "linear"
    # Static capacities, as ModelConfig's.
    max_points: int = 196608
    voxel_capacity: int = 163840
    max_superpoints: int = 3072
    max_gts: int = 128
    compute_dtype: str = "bfloat16"

    @property
    def num_datasets(self) -> int:
        return len(self.datasets)

    level_capacities = ModelConfig.level_capacities


CLASSES_SCANNET = (
    "cabinet", "bed", "chair", "sofa", "table", "door", "window",
    "bookshelf", "picture", "counter", "desk", "curtain", "refrigerator",
    "showercurtrain", "toilet", "sink", "bathtub", "otherfurniture",
)
CLASSES_S3DIS = ("table", "chair", "sofa", "bookcase", "board")
CLASSES_MULTISCAN = (
    "door", "table", "chair", "cabinet", "window", "sofa", "microwave",
    "pillow", "tv_monitor", "curtain", "trash_can", "suitcase", "sink",
    "backpack", "bed", "refrigerator", "toilet",
)
CLASSES_3RSCAN = CLASSES_SCANNET
CLASSES_SCANNETPP = (
    "table", "door", "ceiling lamp", "cabinet", "blinds", "curtain",
    "chair", "storage cabinet", "office chair", "bookshelf", "whiteboard",
    "window", "box", "monitor", "shelf", "heater", "kitchen cabinet",
    "sofa", "bed", "trash can", "book", "plant", "blanket", "tv",
    "computer tower", "refrigerator", "jacket", "sink", "bag", "picture",
    "pillow", "towel", "suitcase", "backpack", "crate", "keyboard", "rack",
    "toilet", "printer", "poster", "painting", "microwave", "shoes",
    "socket", "bottle", "bucket", "cushion", "basket", "shoe rack",
    "telephone", "file folder", "laptop", "plant pot", "exhaust fan",
    "cup", "coat hanger", "light switch", "speaker", "table lamp",
    "kettle", "smoke detector", "container", "power strip", "slippers",
    "paper bag", "mouse", "cutting board", "toilet paper", "paper towel",
    "pot", "clock", "pan", "tap", "jar", "soap dispenser", "binder",
    "bowl", "tissue box", "whiteboard eraser", "toilet brush",
    "spray bottle", "headphones", "stapler", "marker",
)
CLASSES_ARKITSCENES = (
    "cabinet", "refrigerator", "shelf", "stove", "bed", "sink", "washer",
    "toilet", "bathtub", "oven", "dishwasher", "fireplace", "stool",
    "chair", "table", "tv_monitor", "sofa",
)

DATASETS_CLASSES = (
    CLASSES_SCANNET,
    CLASSES_S3DIS,
    CLASSES_MULTISCAN,
    CLASSES_3RSCAN,
    CLASSES_SCANNETPP,
    CLASSES_ARKITSCENES,
)


def default_config(**overrides) -> ModelConfig:
    return dataclasses.replace(ModelConfig(), **overrides)
