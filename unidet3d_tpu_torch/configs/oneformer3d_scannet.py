"""OneFormer3D's ScanNet instance segmentation (mirror of the public
configs/oneformer3d_1xb4_scannet.py of github.com/filapro/oneformer3d), at
inference: ``python -m unidet3d_tpu_torch.tools.test
unidet3d_tpu_torch/configs/oneformer3d_scannet.py <checkpoint_dir>``.
Training it is not ported."""
from unidet3d_tpu_torch.core.config import OneFormer3DConfig
from unidet3d_tpu_torch.core.experiment import DatasetSpec, ExperimentConfig


def get_config() -> ExperimentConfig:
    return ExperimentConfig(
        model=OneFormer3DConfig(),
        datasets=(
            DatasetSpec(
                name="scannet",
                data_root="data/scannet",
                ann_train="scannet_oneformer3d_infos_train.pkl",
                ann_val="scannet_oneformer3d_infos_val.pkl",
            ),
        ),
        batch_size=4,
        epochs=512,
        work_dir="work_dirs/oneformer3d_scannet",
    )
