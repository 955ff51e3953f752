"""The port's experiment files: twins of the repo's ``configs/*.py``, each a
python file with ``get_config() -> ExperimentConfig`` for the port's CLIs
(``python -m unidet3d_tpu_torch.tools.train
unidet3d_tpu_torch/configs/unidet3d_joint.py``)."""
