"""What the two training cells share: the program's step under the window,
what set-up keeps of its first three steps, the reference's three steps
and the comparison that decides ``correct``.

The comparison (the benchmark contract's training rule): set-up drives the
one training object it built through its first steps on three distinct
batches, through the window's own call and feed. The reference (fp32, plain
PyTorch, ``benchmark/reference/refnet``) starts from the same weights (made
from the seed) and follows the first three steps on batches it builds again
from the same scene files and the same random draws. Compared:

  * loss_gap: |loss - ref| / |ref| of the first step (the later steps' gaps
    are printed, not compared: they start from parameters that Adam's
    first, nearly sign-valued update already set apart wherever a gradient
    element is small, and their losses drift with the matcher's choices);
  * fwd_logits_gap, fwd_boxes_gap: the first step's last-layer class logits
    and boxes over the valid queries, |program - ref| / |ref| in norm (a
    yaw modulo pi), the worst scene; query_mismatch: queries valid on one
    side only (limit 0);
  * grad_gap: per leaf, the gap between the norms of the first step's
    clipped gradient (the program's worked out from AdamW's first moment
    after one step, m / (1 - beta1)) over max(the reference leaf's norm,
    the median leaf's);
  * change_gap: per leaf, the gap between the norms of the parameters'
    change after three steps, over max(the reference leaf's, the median
    leaf's), leaving out the leaves whose reference gradient is under a
    thousandth of the median leaf's (their moves are round-off under Adam).
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import statistics
import sys
import time

import numpy as np
import torch

from . import counts
from .gaps import forward_gaps
from .weights import init_from_seed_

CHECKED_STEPS = 3
ADAM_BETA1 = 0.9
SMALL_GRAD = 1e-3  # of the median leaf's reference gradient norm
# Kernel launches per training step: K1, K1', K2, K3, K3-dkv, K3-dq.
STEP_LAUNCHES = (37, 36, 37, 6, 6, 6)


def query_seed(seed: int, step: int) -> int:
    """The query-selection generator's seed for step `step` (from 1)."""
    return int(np.random.SeedSequence([seed, 7, step]).generate_state(1)[0])


def batch_rng(seed: int, n: int) -> np.random.RandomState:
    """Batch n's RandomState, keyed as ``TrainLoader._batch_rng`` keys it."""
    return np.random.RandomState(np.random.SeedSequence([seed, n]).generate_state(4))


def launch_counters():
    from unidet3d_tpu_torch.ops.attention import (flash_attention_cuda, flash_attention_dkv_cuda,
                                                  flash_attention_dq_cuda)
    from unidet3d_tpu_torch.ops.subm_conv_cuda import (subm_conv_cuda, subm_conv_dgrad_cuda,
                                                       subm_conv_wgrad_cuda)
    return (subm_conv_cuda, subm_conv_dgrad_cuda, subm_conv_wgrad_cuda,
            flash_attention_cuda, flash_attention_dkv_cuda, flash_attention_dq_cuda)


def read_launches() -> tuple:
    return tuple(fn.launches for fn in launch_counters())


def launch_mismatch(before: tuple, after: tuple, units: int, per_unit, device) -> int:
    """Launches counted over `units` steps or forwards against per_unit each
    (none off the card: the CPU runs the plain versions)."""
    want = [units * n if device.type == "cuda" else 0 for n in per_unit]
    return int(sum(abs((a - b) - w) for a, b, w in zip(after, before, want)))


def drops_total() -> int:
    from unidet3d_tpu_torch.data.telemetry import DROPS
    return int(sum(DROPS.snapshot().values()))


def model_config(ctx):
    """The port's experiment and ModelConfig of the cell's configuration
    (its experiment module's), with the tests' overrides."""
    exp = importlib.import_module(ctx.config["experiment"]).get_config()
    run = {k: list(v) if isinstance(v, tuple) else v
           for k, v in dataclasses.asdict(exp.model).items()}
    if run != ctx.config["model"]:
        raise ValueError(f"{ctx.config['experiment']} no longer runs the configuration of "
                         f"configs/{ctx.config['name']}.json")
    return exp, dataclasses.replace(exp.model, **ctx.model_overrides)


class Program:
    """The one training object: model, optimizer and step, from the seed."""

    def __init__(self, ctx, cfg):
        from unidet3d_tpu_torch.core.class_table import build_class_table
        from unidet3d_tpu_torch.core.config import DATASETS_CLASSES
        from unidet3d_tpu_torch.models.detector import UniDet3D
        from unidet3d_tpu_torch.parallel.train_step import make_train_step
        from unidet3d_tpu_torch.train.optim import make_optimizer

        self.cfg = cfg
        self.model = init_from_seed_(UniDet3D(cfg, build_class_table(DATASETS_CLASSES),
                                              device=ctx.device), ctx.seed)
        self.names = [n for n, _ in self.model.named_parameters()]
        self.optimizer = make_optimizer(self.model.parameters())
        self.step = make_train_step(self.model, cfg, self.optimizer)
        self.seed = ctx.seed
        self.n_steps = 0
        self.p0 = host_copy(self.model.parameters())
        self.losses, self.g1, self.p3 = [], None, None
        self.out1 = None
        self._hook = self.model.register_forward_hook(self._keep_first_forward)

    def _keep_first_forward(self, module, args, output):
        self.out1 = last_layer(*output)
        self._hook.remove()

    def __call__(self, batch, gt, pack, host_ids) -> dict:
        self.n_steps += 1
        gen = torch.Generator().manual_seed(query_seed(self.seed, self.n_steps))
        return self.step(batch, gt, pack, gen, host_dataset_ids=host_ids)

    def checked(self, metrics) -> None:
        """After each of the first CHECKED_STEPS steps: keep what the
        comparison reads."""
        self.losses.append(float(metrics["loss"]))
        if self.n_steps == 1:
            self.g1 = first_gradient(self.optimizer)
        if self.n_steps == CHECKED_STEPS:
            self.p3 = host_copy(self.model.parameters())

    def kept(self) -> dict:
        return dict(names=self.names, losses=self.losses, g1=self.g1, p0=self.p0, p3=self.p3,
                    out1=self.out1)


def last_layer(out, aux) -> tuple:
    """The last decoder layer's class logits and boxes and the valid
    queries, on the host."""
    return tuple(x.detach().float().cpu() for x in (out.cls_logits[-1], out.boxes[-1])) + (
        aux.query_valid.cpu(),)


def first_gradient(optimizer) -> list:
    """Each parameter's clipped gradient of the first step, from AdamW's
    first moment after it (m = (1 - beta1) g); zero where the optimizer
    holds no moment."""
    state = optimizer.adamw.state
    return [state[p]["exp_avg"].detach().float().cpu() / (1 - ADAM_BETA1)
            if "exp_avg" in state.get(p, {}) else torch.zeros(p.shape)
            for p in optimizer.params]


def host_copy(params) -> list:
    return [p.detach().float().cpu().clone() for p in params]


def free_device() -> None:
    """Returns the freed device memory (the caller dropped its references)."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def reference_steps(ctx, cfg, batches) -> dict:
    """The reference's first CHECKED_STEPS steps, fp32 (or the control's
    precision, ``precision.MANTISSA_BITS``), from the seed's weights, on
    `batches`: [(PointBatch, GTBatch, GridPack, host dataset ids)] on the
    device, built by the reference."""
    from ..reference.refnet.core.class_table import build_class_table
    from ..reference.refnet.core.config import DATASETS_CLASSES
    from ..reference.refnet.models.detector import UniDet3D, detection_loss
    from ..reference.refnet.train.optim import make_optimizer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rcfg = ref_config(cfg, compute_dtype="float32")
    model = init_from_seed_(UniDet3D(rcfg, build_class_table(DATASETS_CLASSES), device=ctx.device),
                            ctx.seed)
    names = [n for n, _ in model.named_parameters()]
    opt = make_optimizer(model.parameters())
    p0 = host_copy(model.parameters())
    losses, g1, out1 = [], None, None
    for i, (batch, gt, pack, ids) in enumerate(batches, start=1):
        gen = torch.Generator().manual_seed(query_seed(ctx.seed, i))
        out, aux = model(batch, pack, train=True, generator=gen)
        if i == 1:
            out1 = last_layer(out, aux)
        loss = detection_loss(rcfg, out, aux, batch, gt, ids)
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        if i == 1:
            g1 = first_gradient(opt)
        del out, aux, loss
    p3 = host_copy(model.parameters())
    del model, opt
    free_device()
    return dict(names=names, losses=losses, g1=g1, p0=p0, p3=p3, out1=out1)


def compare(prog: dict, ref: dict) -> dict:
    """{number: reading} of the comparison (see the module's docstring)."""
    assert prog["names"] == ref["names"], "parameter lists differ"
    loss_gaps = [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])]
    logits, boxes, valid = prog["out1"]
    ref_logits, ref_boxes, ref_valid = ref["out1"]
    n = min(len(valid), len(ref_valid))  # a batch with scenes left out has fewer
    fwd = [forward_gaps(logits[i], boxes[i], ref_logits[i], ref_boxes[i], ref_valid[i])
           for i in range(n)]
    queries = int((valid[:n] != ref_valid[:n]).sum()) + (
        abs(len(valid) - len(ref_valid)) * valid.shape[1])
    rg = [float(g.norm()) for g in ref["g1"]]
    pg = [float(g.norm()) for g in prog["g1"]]
    med = statistics.median(rg)
    grad_gap = max(abs(a - b) / max(b, med) for a, b in zip(pg, rg))
    keep = [g >= SMALL_GRAD * med for g in rg]
    rd = [float((a - b).norm()) for a, b in zip(ref["p3"], ref["p0"])]
    pd = [float((a - b).norm()) for a, b in zip(prog["p3"], prog["p0"])]
    med_d = statistics.median(d for d, k in zip(rd, keep) if k)
    change_gap = max(abs(a - b) / max(b, med_d)
                     for a, b, k in zip(pd, rd, keep) if k)
    if not all(np.isfinite(prog["losses"])):
        loss_gaps = [float("inf")] * len(loss_gaps)
    return {"loss_gap": loss_gaps[0], "fwd_logits_gap": max(g[0] for g in fwd),
            "fwd_boxes_gap": max(g[1] for g in fwd), "grad_gap": grad_gap,
            "change_gap": change_gap, "query_mismatch": queries,
            "later_loss_gaps": loss_gaps[1:], "left_out_leaves": int(len(keep) - sum(keep))}


NUMBERS = ("input_mismatch", "loss_gap", "fwd_logits_gap", "fwd_boxes_gap", "grad_gap",
           "change_gap", "query_mismatch")


def checks(found: dict, limits: dict, drops: int, launch_err: int) -> list:
    """[(name, reading, limit)] of a training run; the later steps' loss gaps
    on standard error."""
    print(f"later steps' loss gaps (not compared): {found['later_loss_gaps']}", file=sys.stderr)
    return [(k, found[k], limits[k]) for k in NUMBERS] + [("drops", drops, 0),
                                                          ("launch_mismatch", launch_err, 0)]


def leaves(tree) -> list:
    """The arrays and numbers of nested (PointBatch, GTBatch, GridPack)
    tuples, in order, as numpy."""
    if isinstance(tree, tuple):
        return [x for t in tree for x in leaves(t)]
    if isinstance(tree, torch.Tensor):
        return [tree.detach().cpu().numpy()]
    return [np.asarray(tree)]


def tree_mismatch(mine, ref) -> int:
    """Elements that differ between two batches (a leaf of another shape
    counts whole)."""
    a, b = leaves(mine), leaves(ref)
    if len(a) != len(b):
        return max(sum(x.size for x in a), sum(x.size for x in b))
    per_leaf = [max(x.size, y.size) if x.shape != y.shape else int((x != y).sum())
                for x, y in zip(a, b)]
    for i, n in enumerate(per_leaf):  # where a batch differs, for the record
        if n:
            print(f"input mismatch: leaf {i} {a[i].shape} / {b[i].shape}: {n} elements",
                  file=sys.stderr)
    return int(sum(per_leaf))


def log_reference(t0: float) -> None:
    """The reference's seconds, on standard error (not a metric)."""
    print(f"reference: {now() - t0:.1f} s", file=sys.stderr)


def gpu_ready(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def now() -> float:
    return time.perf_counter()


def batch_shape(batch_np, pack_np, cfg) -> counts.BatchShape:
    """The counts' view of a collated host batch in training: levels and
    each scene's valid queries (min(superpoints, query_thr, S))."""
    levels = tuple(
        counts.LevelShape(int(pack_np.neighbors[lvl].shape[0]), int(pack_np.n_valid[lvl]),
                          counts.pairs_of(pack_np.neighbors[lvl], int(pack_np.n_valid[lvl])))
        for lvl in range(len(pack_np.n_valid)))
    q_cap = min(cfg.query_thr, cfg.max_superpoints)
    queries = tuple(min(len(np.unique(sp[v])), q_cap)
                    for sp, v in zip(batch_np.sp_ids, batch_np.valid))
    return counts.BatchShape(levels, queries)


def ref_config(cfg, **over):
    """The reference's ModelConfig with `cfg`'s values."""
    from ..reference.refnet.core.config import ModelConfig

    return ModelConfig(**dict(dataclasses.asdict(cfg), **over))


def query_slots(cfg) -> int:
    """The decoder's padded query slots in training (Q)."""
    q_real = min(cfg.query_thr, cfg.max_superpoints)
    return min(-(-q_real // 512) * 512, cfg.max_superpoints) if q_real >= 512 else q_real


def model_dims(cfg) -> dict:
    from ..reference.refnet.core.class_table import build_class_table
    from ..reference.refnet.core.config import DATASETS_CLASSES

    return dict(planes=tuple(cfg.num_planes), d_model=cfg.d_model, num_heads=cfg.num_heads,
                hidden=cfg.hidden_dim, num_layers=cfg.num_layers,
                n_classes=int(build_class_table(DATASETS_CLASSES).gather.max()) + 1)
