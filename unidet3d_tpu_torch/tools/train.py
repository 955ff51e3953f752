"""Training CLI, the port of the JAX package's ``tools/train.py``:

  python -m unidet3d_tpu_torch.tools.train <config.py> [--work-dir D]
      [--resume [auto|STEP]] [--cfg-options key=val ...]
      [--precision bf16|fp32] [--auto-scale-lr] [--device cuda|cpu]

The config is a python file with ``get_config() -> ExperimentConfig`` (the
port's own: ``unidet3d_tpu_torch/configs/``). Mixed precision is on by default
(``ModelConfig.compute_dtype`` bfloat16, fp32 accumulation); ``--precision
fp32`` turns it off. It runs on the card; ``--device cpu`` runs the plain
PyTorch versions on the CPU, and without a card and without that flag it
raises.

Data-parallel training, one process per card, on one host:

  torchrun --nproc_per_node N -m unidet3d_tpu_torch.tools.train <config.py>

(and with --nnodes / --node_rank / --master_addr across hosts, the work
directory on a shared file system). The config's batch_size is the global
batch; each rank trains on batch_size / N scenes of it on card LOCAL_RANK.
The backend is NCCL when every local rank has a card of its own, gloo on the
CPU or when ranks share a card (``parallel/distributed.py``).
"""
from __future__ import annotations

import argparse
import dataclasses
import logging


def main(argv=None):
    ap = argparse.ArgumentParser(description="Train a UniDet3D model (PyTorch port)")
    ap.add_argument("config", help="experiment config python file")
    ap.add_argument("--work-dir", default=None)
    ap.add_argument(
        "--resume", nargs="?", const="auto", default=None,
        help="resume from latest ('auto') or a specific step",
    )
    ap.add_argument("--cfg-options", nargs="*", default=[])
    ap.add_argument(
        "--precision", choices=("bf16", "fp32"), default=None,
        help="compute dtype of the backbone and decoder (default: the config's "
        "compute_dtype, bf16 in production; fp32 turns mixed precision off)",
    )
    ap.add_argument(
        "--auto-scale-lr", action="store_true",
        help="linearly scale the configured lr by batch_size / base_batch_size",
    )
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' (the plain PyTorch versions)")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")

    from ..core.experiment import apply_overrides, load_experiment

    # The config first, then the heavy imports (as the JAX CLI does).
    exp = load_experiment(args.config)
    from ..device import resolve_device
    from ..parallel.distributed import destroy, maybe_initialize, rank_device
    from ..train.loop import train

    device = rank_device(resolve_device(args.device))
    exp = apply_overrides(exp, args.cfg_options)
    if args.work_dir:
        exp = dataclasses.replace(exp, work_dir=args.work_dir)
    if args.precision:
        dtype = "bfloat16" if args.precision == "bf16" else "float32"
        exp = dataclasses.replace(exp, model=dataclasses.replace(exp.model, compute_dtype=dtype))
    if args.auto_scale_lr:
        scale = exp.batch_size / exp.base_batch_size
        logging.getLogger("unidet3d_tpu_torch").info(
            "auto-scale-lr: %g -> %g (batch %d / base %d)",
            exp.lr, exp.lr * scale, exp.batch_size, exp.base_batch_size,
        )
        exp = dataclasses.replace(exp, lr=exp.lr * scale)
    created = maybe_initialize()
    try:
        return train(exp, resume=args.resume, device=device)
    finally:
        destroy(created)


if __name__ == "__main__":
    main()
