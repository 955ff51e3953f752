"""Joint 6-dataset experiment (mirror of reference
configs/unidet3d_1xb8_scannet_s3dis_multiscan_3rscan_scannetpp_arkitscenes.py),
the port's twin of the repo's ``configs/unidet3d_joint.py``. One process and
one card until the data-parallel slice (the JAX config's mesh axis)."""
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
            # S3DIS: five per-area train datasets, each partition 0.33
            # (reference config:600-614); val = Area 5 (config:676-687).
            *(
                DatasetSpec(
                    name="s3dis",
                    data_root="data/s3dis",
                    ann_train=f"s3dis_infos_Area_{a}.pkl",
                    ann_val="s3dis_infos_Area_5.pkl" if a == 1 else None,
                    partition=0.33,
                )
                for a in (1, 2, 3, 4, 6)
            ),
            # Partitions of the reference joint config (config:607-640):
            # multiscan 0.25, 3rscan 0.15, scannetpp 0.33, arkitscenes 0.08.
            DatasetSpec(
                name="multiscan",
                data_root="data/multiscan",
                ann_train="multiscan_infos_train.pkl",
                ann_val="multiscan_infos_val.pkl",
                partition=0.25,
            ),
            DatasetSpec(
                name="3rscan",
                data_root="data/3rscan",
                ann_train="3rscan_infos_train.pkl",
                ann_val="3rscan_infos_val.pkl",
                partition=0.15,
            ),
            DatasetSpec(
                name="scannetpp",
                data_root="data/scannetpp",
                ann_train="scannetpp_infos_train.pkl",
                ann_val="scannetpp_infos_val.pkl",
                partition=0.33,
            ),
            DatasetSpec(
                name="arkitscenes",
                data_root="data/arkitscenes",
                ann_train="arkitscenes_infos_train.pkl",
                ann_val="arkitscenes_infos_val.pkl",
                partition=0.08,
            ),
        ),
        batch_size=8,
        epochs=1024,
        work_dir="work_dirs/unidet3d_joint",
    )
