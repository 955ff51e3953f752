"""Evaluation CLI, the port of the JAX package's ``tools/test.py``:

  python -m unidet3d_tpu_torch.tools.test <config.py> <checkpoint_dir>
      [--step N] [--show] [--show-dir DIR] [--cfg-options key=val ...]
      [--device cuda|cpu]

Builds the model, restores the checkpoint strictly (the latest step unless
``--step``), runs ``train.loop.evaluate`` and prints one
``name: mAP@0.25=... mAP@0.50=...`` line per dataset (UniDet3D), or
``name: AP=... AP50=... AP25=... mIoU=...`` (OneFormer3D's
``configs/oneformer3d_scannet.py``). ``--show-dir`` writes
each scene's points, ground truth and predictions as .obj files under
DIR/<dataset>_scene<k>/ (k: the scene's index in its info file); ``--show``
opens each scene in the open3d viewer, and without open3d warns once and
evaluates on.

Under torchrun (``torchrun --nproc_per_node N -m
unidet3d_tpu_torch.tools.test ...``) every rank restores the same checkpoint
on card LOCAL_RANK, evaluates a strided shard of each dataset, and the
metric gathers the detections, so every rank prints the same numbers.
"""
from __future__ import annotations

import argparse
import logging


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="Evaluate a UniDet3D or OneFormer3D model "
                                             "(PyTorch port)")
    ap.add_argument("config")
    ap.add_argument("checkpoint", help="checkpoint directory (<work_dir>/checkpoints)")
    ap.add_argument("--step", type=int, default=None)
    ap.add_argument("--show", action="store_true",
                    help="open each scene in the open3d viewer")
    ap.add_argument("--show-dir", default=None,
                    help="write each scene's points, GT and predictions as .obj files here")
    ap.add_argument("--cfg-options", nargs="*", default=[])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' (the plain PyTorch versions)")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO)

    from ..core.experiment import apply_overrides, load_experiment

    exp = load_experiment(args.config)
    exp = apply_overrides(exp, args.cfg_options)

    from ..device import resolve_device
    from ..parallel.distributed import destroy, maybe_initialize, rank_device
    from ..train.checkpoint import CheckpointManager
    from ..train.loop import build_model, evaluate

    device = rank_device(resolve_device(args.device))
    created = maybe_initialize()
    try:
        model, _ = build_model(exp, device)
        step = CheckpointManager(args.checkpoint).restore(model, step=args.step)
        if step is None:
            raise FileNotFoundError(f"no checkpoint found in {args.checkpoint}")
        logging.getLogger("unidet3d_tpu_torch").info("restored step %d from %s", step,
                                                     args.checkpoint)
        results = evaluate(exp, model, device=device, show=args.show,
                           show_dir=args.show_dir)
    finally:
        destroy(created)
    for name, res in results.items():
        if "AP" in res:  # instance segmentation
            print(f"{name}: AP={res['AP']:.4f} AP50={res['AP50']:.4f} "
                  f"AP25={res['AP25']:.4f} mIoU={res['mIoU']:.4f}")
        else:
            print(f"{name}: mAP@0.25={res.get('mAP_0.25', 0):.4f} "
                  f"mAP@0.50={res.get('mAP_0.50', 0):.4f}")
    return results


if __name__ == "__main__":
    main()
