"""ScanNet-only experiment (mirror of reference configs/unidet3d_1xb8_scannet.py),
the port's twin of the repo's ``configs/unidet3d_scannet.py``."""
from unidet3d_tpu_torch.core.config import default_config
from unidet3d_tpu_torch.core.experiment import DatasetSpec, ExperimentConfig


def get_config() -> ExperimentConfig:
    return ExperimentConfig(
        model=default_config(),
        datasets=(
            DatasetSpec(
                name="scannet",
                data_root="data/scannet",
                ann_train="scannet_infos_train.pkl",
                ann_val="scannet_infos_val.pkl",
            ),
        ),
        batch_size=8,
        epochs=1024,
        work_dir="work_dirs/unidet3d_scannet",
    )
