"""Record the eval forward's activations at fixed probe points into an .npz.

The port's counterpart of the JAX package's ``tools/record_activations.py``,
with the same probe names, so that one recording of either package can be
held against the other (``tests/fixtures/activations_seed0.npz`` is the JAX
recorder's, seeded init, 4,096 points, ``max_superpoints`` 512):

  inter/backbone/__call__/0      (V0, C) voxel features leaving the U-Net
  inter/decoder/__call__/0/0     (L + 1, B, Q, NC + 1) class logits per output set
  inter/decoder/__call__/0/1     (L + 1, B, Q, 7) boxes per output set
  out/cls_logits, out/boxes      the detector's outputs (the decoder's)
  aux/sp_valid, aux/sp_centers   the superpoint mask and centers

The probes are forward hooks on ``backbone`` and ``decoder``.

Usage:
  python -m unidet3d_tpu_torch.tools.record_activations out.npz \\
      [--params converted.pth] [--seed 0] [--points scene.bin] \\
      [--n-points 4096] [--config cfg.py] [--device cuda|cpu]

``--params`` is a state dict written by ``train/checkpoint.py::save_params``
(``tools/convert_checkpoint.py``'s output); without it the weights come from
``weights.seeded_init_(model, seed)``.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch


def record_activations(model, batch, pack) -> dict:
    """The eval forward of `model` on (batch, pack), already on the model's
    device; returns {probe name: numpy array}."""
    caught = {}
    hooks = [
        getattr(model, name).register_forward_hook(
            lambda mod, args, out, name=name: caught.__setitem__(name, out))
        for name in ("backbone", "decoder")
    ]
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            out, aux = model(batch, pack)
    finally:
        model.train(was_training)
        for h in hooks:
            h.remove()

    def host(x):
        return x.detach().cpu().numpy()

    dec = caught["decoder"]
    return {
        "inter/backbone/__call__/0": host(caught["backbone"]),
        "inter/decoder/__call__/0/0": host(dec.cls_logits),
        "inter/decoder/__call__/0/1": host(dec.boxes),
        "out/cls_logits": host(out.cls_logits),
        "out/boxes": host(out.boxes),
        "aux/sp_valid": host(aux.sp_valid),
        "aux/sp_centers": host(aux.sp_centers),
    }


def build_fixture_inputs(cfg, seed: int = 0, n_points: int = 4096,
                         points: np.ndarray | None = None):
    """(batch, pack) of numpy arrays for a deterministic probe scene: a
    synthetic surface scene (or `points`) with stripes of 64 points as
    superpoints."""
    from ..data.batcher import collate
    from ..data.synthetic import stripe_superpoints, synthetic_scene

    if points is None:
        points = synthetic_scene(n_points, seed=seed)
    sample = {
        "points": points.astype(np.float32),
        "dataset_idx": 0,
        "sp_pts_mask": stripe_superpoints(points, 64),
    }
    batch, _, pack = collate([sample], cfg, rng=np.random.RandomState(seed))
    return batch, pack


def fixture_experiment(n_points: int):
    """The production architecture at the fixture's small capacities."""
    from ..core.config import default_config
    from ..core.experiment import DatasetSpec, ExperimentConfig

    return ExperimentConfig(
        model=default_config(max_points=max(n_points, 4096),
                             voxel_capacity=max(n_points, 4096), max_superpoints=512),
        datasets=(DatasetSpec(name="scannet", data_root="."),),
    )


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="Record the eval forward's probes (PyTorch port)")
    ap.add_argument("out", help="output .npz")
    ap.add_argument("--params", default=None,
                    help="state dict from save_params (convert_checkpoint's output); "
                    "omitted: seeded_init_(seed)")
    ap.add_argument("--config", default=None,
                    help="experiment config .py (default: the fixture's config)")
    ap.add_argument("--points", default=None, help="(N, 6) float32 .bin scene; omitted: synthetic")
    ap.add_argument("--n-points", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' (the plain PyTorch versions)")
    args = ap.parse_args(argv)

    from ..data.batcher import to_device
    from ..device import resolve_device
    from ..train.loop import build_model
    from ..weights import seeded_init_

    device = resolve_device(args.device)
    if args.config:
        from ..core.experiment import load_experiment

        exp = load_experiment(args.config)
    else:
        exp = fixture_experiment(args.n_points)
    model, _ = build_model(exp, device)
    if args.params:
        from ..train.checkpoint import restore_params

        model.load_state_dict(restore_params(args.params), strict=True)
    else:
        seeded_init_(model, args.seed)

    pts = None
    if args.points:
        pts = np.fromfile(args.points, np.float32).reshape(-1, 6)
    batch, pack = build_fixture_inputs(exp.model, seed=args.seed, n_points=args.n_points,
                                       points=pts)
    rec = record_activations(model, *to_device(batch, pack, device))
    np.savez_compressed(args.out, **rec)
    total = sum(v.size for v in rec.values())
    print(f"recorded {len(rec)} probes ({total} values) on {device} -> {args.out}")
    return rec


if __name__ == "__main__":
    main()
