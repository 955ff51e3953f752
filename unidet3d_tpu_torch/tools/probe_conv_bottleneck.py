"""Bottleneck bisection of K1, the submanifold conv forward, on the card.

    python3 -m unidet3d_tpu_torch.tools.probe_conv_bottleneck
    python3 -m unidet3d_tpu_torch.tools.probe_conv_bottleneck --device cpu --cap 4096

Runs the four modes of K1's kernel (``ops/probe_conv.py``) at the
production level-0 shape: one synthetic 131,072-point scene (seed 5), its
level-0 neighbor table, features (V, 32) and weights (27, 32, 32) in bf16
from ``np.random.RandomState(0)``. For each mode it checks the output against
the plain version (rtol = atol = 1e-3), checks that ``full`` gives K1's bits,
and on the card times the modes in turn, in rounds of back-to-back launches
(the L2 cache stays warm between them; CUDA events), so that a change of the
card's clocks during the run reaches every mode alike; a mode's time is the
median of its rounds. It prints each time beside the mode's bound and work,
its plain version's time and that of one PyTorch call that computes the
same function, then the gaps that bisect K1:

  * full - gather_only: the weight staging and the products;
  * full - no_gather: gathering the neighbors' rows instead of the tile's own;
  * no_gather - no_table: the table read and the per-offset skip, net of the
    offsets that no_table stages and the skip spares.

Without CUDA it raises unless ``--device cpu`` is given; the CPU runs the
plain versions at the cap the caller sets and times nothing.
"""
from __future__ import annotations

import argparse
import statistics
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.config import default_config
from ..data.synthetic import synthetic_scene
from ..device import card_line, cuda_ms, resolve_device
from ..ops.gridpack import build_gridpack_numpy, quantize_points
from ..ops.probe_conv import MODES, probe_conv_cuda, probe_conv_plain, probe_work
from ..ops.subm_conv_cuda import subm_conv_cuda

SCENE_POINTS = 131072
SEED = 5
CHANNELS = 32
TOL = dict(rtol=1e-3, atol=1e-3)  # the same fp32 sums of bf16 products in another order
# The library calls round their output (and einsum its sum_o W[o]) to bf16:
# their largest error, relative to the largest output, stays below this.
LIBRARY_RTOL = 2e-2
# A round times REPS back-to-back launches of one mode after as many untimed
# ones; ROUNDS rounds take the modes in turn. A mode takes 0.04-0.3 ms: one
# window per mode, right after the build, read up to 3x apart between runs.
REPS = 200
ROUNDS = 5


class ProbeInputs(NamedTuple):
    features: torch.Tensor  # (V, 32) bf16
    neighbors: torch.Tensor  # (V, 27) int32, sentinel V
    weights: torch.Tensor  # (27, 32, 32) bf16
    n_valid: int


def probe_table(cap: int = SCENE_POINTS):
    """The probe's scene and its level-0 table: synthetic_scene(cap, seed=5),
    quantised at the default voxel size, with a voxel capacity of `cap`.

    Returns:
        (points (cap, 6) float32, neighbors (cap, 27) int32, n_valid).
    """
    cfg = default_config(max_points=cap, voxel_capacity=cap)
    points = synthetic_scene(cap, seed=SEED)
    vox_src = (points[None, :, :3] / cfg.voxel_size).astype(np.float32)
    valid = np.ones((1, len(points)), bool)
    pack, _ = build_gridpack_numpy(
        quantize_points(vox_src, valid), valid.reshape(-1), [cfg.voxel_capacity])
    return points, pack.neighbors[0], pack.n_valid[0]


def probe_inputs(cap: int = SCENE_POINTS, device="cuda") -> ProbeInputs:
    """The probe's table and tensors on `device`: features randn(cap, 32)
    and weights randn(27, 32, 32) * 0.1, both bf16, from RandomState(0)."""
    device = resolve_device(device)
    _, nbr, n_valid = probe_table(cap)
    rng = np.random.RandomState(0)
    feat = rng.randn(cap, CHANNELS).astype(np.float32)
    w = (rng.randn(27, CHANNELS, CHANNELS) * 0.1).astype(np.float32)
    return ProbeInputs(
        features=torch.from_numpy(feat).to(device, torch.bfloat16),
        neighbors=torch.from_numpy(nbr).to(device),
        weights=torch.from_numpy(w).to(device, torch.bfloat16),
        n_valid=n_valid,
    )


def run_modes(inputs: ProbeInputs) -> dict:
    """One call of each mode: {mode: (V, 32) fp32 output}."""
    return {mode: probe_conv_cuda(mode, *inputs) for mode in MODES}


def library_calls(inputs: ProbeInputs) -> dict:
    """{mode: (label, fn)}: the PyTorch call that computes each mode's
    function on the valid rows (for full, K1's yardstick: index_select and
    one mm), timed beside the kernel and used nowhere in the port."""
    feat, nbr, w, n = inputs
    v, cin = feat.shape
    pad_f = torch.cat([feat, feat.new_zeros(1, cin)])  # row v: zeros for "no neighbor"
    table = nbr[:n].long()
    valid = (table >= 0) & (table < v)
    bags = torch.where(valid, table, v)
    mask, own = valid.to(feat.dtype), feat[:n]
    return {
        "full": ("index_select+mm", lambda: pad_f.index_select(0, bags.view(-1)).view(
            n, 27 * cin) @ w.view(27 * cin, -1)),
        "gather_only": ("embedding_bag", lambda: F.embedding_bag(bags, pad_f, mode="sum")),
        "no_gather": ("einsum", lambda: torch.einsum("vo,vk,okc->vc", mask, own, w)),
        "no_table": ("einsum", lambda: torch.einsum("vk,okc->vc", own, w)),
    }


def measure(inputs: ProbeInputs, outs: dict, card: str | None) -> dict:
    """Checks `outs` (from run_modes on `inputs`) against the plain versions
    and `full` against K1's bits; on the card (`card` is its name and power
    limit) also checks each mode's library call and times each mode, its
    plain version and its library call. Prints the bisection and returns
    {mode: dict(max_abs_err, ms, plain_ms, library_ms, bound_ms, bound_by,
    work)}, times None on the CPU."""
    feat, nbr, w, n = inputs
    v, cin = feat.shape
    k1 = subm_conv_cuda(feat, nbr, w, n)
    if not torch.equal(outs["full"], k1):
        raise AssertionError("probe full differs from K1 (subm_conv_cuda)")
    library = library_calls(inputs) if card is not None else {}
    res = {}
    for mode in MODES:
        ref = probe_conv_plain(mode, *inputs)
        torch.testing.assert_close(outs[mode], ref, **TOL, msg=f"probe {mode}")
        work = probe_work(mode, nbr, n, cin, w.shape[2], feat.element_size())
        bound_ms, bound_by = work.bound()
        r = dict(max_abs_err=(outs[mode] - ref).abs().max().item(), ms=None,
                 plain_ms=None, library_ms=None, bound_ms=bound_ms,
                 bound_by=bound_by, work=work)
        if mode in library:
            label, call = library[mode]
            lib_err = (call().float() - ref[:n]).abs().max().item()
            if lib_err > LIBRARY_RTOL * ref.abs().max().item():
                raise AssertionError(f"{label} does not compute probe {mode}: err {lib_err}")
            r["plain_ms"] = cuda_ms(lambda: probe_conv_plain(mode, *inputs), reps=3)
            r["library_ms"] = cuda_ms(call, reps=3)
            r["library"] = f"{label}, err {lib_err:.1e}"
        res[mode] = r
    rounds = {mode: [] for mode in library}
    for _ in range(ROUNDS if library else 0):
        for mode, times in rounds.items():
            times.append(cuda_ms(lambda: probe_conv_cuda(mode, *inputs), reps=REPS,
                                 warmup=REPS))
    for mode, times in rounds.items():
        res[mode]["ms"] = statistics.median(times)
        res[mode]["rounds"] = times
    _report(inputs, res, card)
    return res


def _report(inputs: ProbeInputs, res: dict, card: str | None) -> None:
    feat, _, w, n = inputs
    where = card or "CPU, plain versions, no times"
    print(f"[P1] scene {feat.shape[0]} pts (seed {SEED}), level 0: V {feat.shape[0]}, n_valid {n}, "
          f"{feat.shape[1]}->{w.shape[2]} {str(feat.dtype).replace('torch.', '')}; "
          f"times per probe call, L2 warm (rounds of {REPS} back-to-back launches, the modes "
          f"in turn) | {where}")
    for mode, r in res.items():
        wk = r["work"]
        times = "times not measured" if r["ms"] is None else (
            f"{r['ms']:.4f} ms per conv (median of {len(r['rounds'])} rounds, "
            f"{min(r['rounds']):.4f}-{max(r['rounds']):.4f}), plain {r['plain_ms']:.4f} ms, "
            f"library {r['library_ms']:.4f} ms ({r['library']})")
        print(f"[P1] {mode:11s}: err {r['max_abs_err']:.1e}; {times}; bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}; {wk.ops} operations needed); "
              f"the kernel's own arithmetic at the fp32-unit rate {wk.fp32_unit_ms():.4f} ms; "
              f"{wk.tile_offsets} tile-offsets, "
              f"{wk.pairs} pairs, {wk.fmas} FMAs, {wk.adds} adds, reads "
              f"{wk.bytes_read / 1e6:.2f} MB once, loads {wk.bytes_loaded / 1e6:.2f} MB, "
              f"writes {wk.bytes_written / 1e6:.2f} MB | {where}")
    if card is None:
        return
    ms = {mode: r["ms"] for mode, r in res.items()}
    print(f"[P1] gaps: full - gather_only {ms['full'] - ms['gather_only']:.4f} ms "
          f"(weight staging + products), full - no_gather {ms['full'] - ms['no_gather']:.4f} ms "
          f"(the neighbor gather), no_gather - no_table "
          f"{ms['no_gather'] - ms['no_table']:.4f} ms (table read + skip) | {card}")


def main(device="cuda", cap: int = SCENE_POINTS) -> dict:
    """The bisection on `device` (the card unless "cpu" is asked for) at a
    scene of `cap` points; returns measure()'s results."""
    device = resolve_device(device)
    card = card_line() if device.type == "cuda" else None
    if card is not None:
        torch.backends.cuda.matmul.allow_tf32 = False
    inputs = probe_inputs(cap, device)
    return measure(inputs, run_modes(inputs), card)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--cap", type=int, default=SCENE_POINTS,
                        help="scene points and level-0 voxel capacity")
    args = parser.parse_args()
    main(args.device, args.cap)
