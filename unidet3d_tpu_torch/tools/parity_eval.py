"""Checkpoint-parity evaluation against the released model, in one command.

The port's counterpart of the JAX package's ``tools/parity_eval.py``. The aim
is mAP@0.25 / 0.50 within 0.3 of the released ``unidet3d.pth`` on each
dataset (the reference README's checkpoint-eval workflow). It:

  1. converts the reference checkpoint (``tools/convert_checkpoint.py``:
     wrapper prefixes stripped, unconsumed keys reported),
  2. re-anchors genuine mmdet3d-v2 info pkls when the port-format val info
     file is absent (``tools/convert_mmdet3d_infos.py``),
  3. evaluates every configured dataset whose val infos are on disk
     (``train/loop.py::evaluate`` on ``--device``),
  4. prints each dataset's mAP@0.25 / 0.50 beside the reference README's,
     with the delta.

Exit codes: 2 with no checkpoint or no dataset with val infos, 1 when a
|delta| exceeds ``--tolerance`` (percentage points), 0 otherwise.

Usage:
  python -m unidet3d_tpu_torch.tools.parity_eval unidet3d.pth \\
      [--config unidet3d_tpu_torch/configs/unidet3d_joint.py] [--tolerance 0.3] \\
      [--datasets scannet ...] [--cfg-options key=val ...] [--device cuda|cpu]

A dataset without val infos is skipped with a notice, so the same command
serves a ScanNet-only layout and the full six datasets.
"""
from __future__ import annotations

import argparse
import logging
import os
import sys

log = logging.getLogger("unidet3d_tpu_torch")

# The reference README's released-checkpoint metrics (mAP@0.25, @0.50).
REFERENCE_MAP = {
    "scannet": (77.0, 65.9),
    "arkitscenes": (60.1, 47.2),
    "s3dis": (76.7, 65.3),
    "multiscan": (62.6, 52.3),
    "3rscan": (63.6, 44.9),
    "scannetpp": (24.0, 16.8),
}


def _ensure_infos(spec) -> bool:
    """Whether the val info file of `spec` exists, after converting a
    genuine mmdet3d-v2 pkl found under data_root/mmdet3d/ (or named v2_*
    beside it) when it does not."""
    if spec.ann_val is None:
        return False
    ann = os.path.join(spec.data_root, spec.ann_val)
    if os.path.exists(ann):
        return True
    # Names written by the reference's create_data / update_infos_to_v2.
    for cand_name in (
        spec.ann_val,
        f"{spec.name}_infos_val.pkl",
        "infos_val.pkl",
        f"{spec.name}_oneformer3d_infos_val.pkl",
    ):
        cand = os.path.join(spec.data_root, "mmdet3d", cand_name)
        if not os.path.exists(cand):
            cand = os.path.join(spec.data_root, "v2_" + cand_name)
        if os.path.exists(cand):
            from .convert_mmdet3d_infos import convert_infos

            log.info("re-anchoring mmdet3d-v2 infos %s -> %s", cand, ann)
            convert_infos(cand, ann)
            return True
    return False


def delta_table(results: dict, tolerance: float):
    """(lines of the table, names of datasets beyond `tolerance`) for
    evaluate()'s results, in percentage points against REFERENCE_MAP."""
    lines = [f"{'dataset':<12} {'mAP@0.25':>9} {'ref':>6} {'d':>6}  "
             f"{'mAP@0.50':>9} {'ref':>6} {'d':>6}"]
    failed = []
    for name, res in results.items():
        ours = (100 * res.get("mAP_0.25", 0.0), 100 * res.get("mAP_0.50", 0.0))
        ref = REFERENCE_MAP.get(name)
        if ref is None:
            lines.append(f"{name:<12} {ours[0]:9.1f} {'--':>6} {'--':>6}  "
                         f"{ours[1]:9.1f} {'--':>6} {'--':>6}")
            continue
        d25, d50 = ours[0] - ref[0], ours[1] - ref[1]
        lines.append(f"{name:<12} {ours[0]:9.1f} {ref[0]:6.1f} {d25:+6.1f}  "
                     f"{ours[1]:9.1f} {ref[1]:6.1f} {d50:+6.1f}")
        if max(abs(d25), abs(d50)) > tolerance:
            failed.append(name)
    return lines, failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Checkpoint-parity evaluation (PyTorch port)")
    ap.add_argument("checkpoint", help="reference torch .pth file")
    ap.add_argument("--config", default="unidet3d_tpu_torch/configs/unidet3d_joint.py")
    ap.add_argument("--tolerance", type=float, default=0.3,
                    help="max |mAP delta| (percentage points) to pass")
    ap.add_argument("--datasets", nargs="*", default=None,
                    help="restrict to these dataset names")
    ap.add_argument("--cfg-options", nargs="*", default=[])
    ap.add_argument("--planes", type=int, nargs="+", default=[32, 64, 96, 128, 160])
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' (the plain PyTorch versions)")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(message)s")

    if not os.path.exists(args.checkpoint):
        print(f"checkpoint not found: {args.checkpoint}", file=sys.stderr)
        print("(the released unidet3d.pth: see the reference README's checkpoint "
              "section)", file=sys.stderr)
        return 2

    import dataclasses

    import torch

    from ..core.experiment import apply_overrides, load_experiment
    from ..device import resolve_device
    from ..train.loop import build_model, evaluate
    from .convert_checkpoint import convert_state_dict

    device = resolve_device(args.device)
    exp = apply_overrides(load_experiment(args.config), args.cfg_options)

    # Only the datasets asked for that have val infos on disk.
    keep = []
    for spec in exp.datasets:
        if args.datasets and spec.name not in args.datasets:
            continue
        if _ensure_infos(spec):
            keep.append(spec)
        else:
            log.info("skipping %s: no val infos under %s", spec.name, spec.data_root)
    if not keep:
        print("no dataset has val infos on disk: nothing to evaluate", file=sys.stderr)
        return 2
    exp = dataclasses.replace(exp, datasets=tuple(keep))

    # weights_only: the file comes from outside the program.
    ckpt = torch.load(args.checkpoint, map_location="cpu", weights_only=True)
    report: dict = {}
    converted = convert_state_dict(
        ckpt.get("state_dict", ckpt), num_levels=len(args.planes), num_layers=args.layers,
        d_model=args.d_model, report=report)
    log.info("converted %d checkpoint tensors", report["consumed"])
    if report["unexpected"]:
        log.warning("unconsumed checkpoint keys: %s", report["unexpected"])

    model, _ = build_model(exp, device)
    model.load_state_dict(converted, strict=True)
    results = evaluate(exp, model, device=device)

    lines, failed = delta_table(results, args.tolerance)
    print("\n" + "\n".join(lines))
    if failed:
        print(f"\nPARITY FAIL (|delta| > {args.tolerance}): {failed}")
        return 1
    print(f"\nPARITY OK (all deltas within {args.tolerance})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
