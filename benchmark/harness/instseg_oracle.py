"""The comparison that decides ``correct`` in the OneFormer3D eval cell.

After the window, with the program's state freed, the plain fp32 reference
(``benchmark/reference/oneformer3d/plain.py``, over ``refnet``'s U-Net)
judges what the first window pass produced, for a seed-drawn sample of its
groups (each scene one at a time, as the reference runs):

  * input_mismatch: each sampled scene's points as the program's batch held
    them against the reference's own test pipeline over the raw scene file
    (rows that differ), plus the superpoint slots valid on one side only;
  * fwd_logits_gap, fwd_mask_gap: the reference's forward, teacher-forced
    with the program's own per-layer attention bitmasks (so that one bit
    decided on the other side of zero cannot send the two apart), against
    the program's last-set class logits and mask logits over the scene's
    valid queries and superpoints, the worst scene. Class logits:
    |program - reference| / |reference| in norm. Mask logits: |program -
    reference| over |norm(q)| |x_mask(sp)|, the norms of the product's
    operands (the reference's), over which rounding errors spread: the
    logits are dot products of 256-wide vectors that nearly cancel, so their
    own norm would measure the cancellation of the seed's weights more than
    the precision (over |reference|, on an NVIDIA H100 80GB HBM3, the
    program read 0.011-0.054 on eight seeds and the e4m3 control 0.075-0.20
    on three: no room for a limit);
  * mask_flips: the (layer, query, superpoint) whose bit in the program's
    mask differs from the sign of the reference's own logit of the set that
    mask came from, where that logit is further than `band` from zero. A
    row the program opened whole is read the way that gives fewer flips
    (its logits all >= 0, or all < 0 and reopened), so that a row whose
    reopening turned on one logit near zero counts once as that logit does;
  * post_mismatch: the reference's post-processing (``pred_inst``,
    ``pred_sem``) of the program's own last-set outputs against the
    program's instances: instances kept on one side only, or kept on both
    with another label, superpoint mask or a score beyond 1e-5 of its
    scale, plus superpoints of another semantic class;
  * ap_gap: ScanNet's instance AP and mmdet3d's semantic mIoU computed per
    point by the reference from the program's instances and semantic map of
    every scene of the pass, with the reference's own ground truth, against
    the program's metric: the largest difference of any reported number
    (a nan on one side only reads inf);
  * planted_ap_gap: the same comparison over predictions planted from each
    scene's own ground truth (``planted_predictions``), fed through the
    program's counts and drain (``train/instance_metric.py::count_group``,
    ``train/loop.py::drain``) as a pass of the model's would be. With random weights the
    model's own instances match no ground truth (every AP reads 0 on both
    sides), so ap_gap alone cannot see a fault of the matching; the planted
    ones match at every overlap, duplicate, take the wrong class, fall under
    the 100-point floor and cover void, so that each rule of ScanNet's
    evaluation moves a number.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .gaps import rel_gap

NUMBERS = ("input_mismatch", "fwd_logits_gap", "fwd_mask_gap", "mask_flips", "post_mismatch",
           "ap_gap", "planted_ap_gap")
SCORE_TOL = 1e-5
PLANTED_RANDOM = 8  # random masks planted per scene
PLANTED_DENSITY = 0.05  # their share of the scene's superpoint slots


@dataclasses.dataclass
class Checked:
    kept: dict  # group index -> the sampled group's forward (host or device tensors)
    sampled: list  # group indices of the sampled groups
    predictions: dict  # group index -> the program's instances of the pass
    results: dict  # the program's metric of the pass: {dataset: {number: value}}


def reference_model(cfg, seed: int, device):
    from ..reference.oneformer3d.plain import Reference
    from .weights import init_from_seed_

    ref = Reference(num_planes=tuple(cfg.num_planes), in_channels=cfg.in_channels,
                    num_layers=cfg.num_layers, d_model=cfg.d_model, num_heads=cfg.num_heads,
                    hidden_dim=cfg.hidden_dim, n_sem=cfg.num_semantic_queries,
                    n_classes=cfg.num_instance_classes).to(device)
    return init_from_seed_(ref, seed).eval()


def ref_config(cfg, max_superpoints: int):
    """refnet's ModelConfig with the program's capacities (its collate and
    rulebooks read them)."""
    from ..reference.refnet.core.config import ModelConfig

    return ModelConfig(max_points=cfg.max_points, voxel_capacity=cfg.voxel_capacity,
                       max_superpoints=max_superpoints, max_gts=cfg.max_gts,
                       voxel_size=cfg.voxel_size, num_planes=tuple(cfg.num_planes),
                       compute_dtype="float32")


def reference_scene(root: str, ann: str, k: int):
    """Scene k of the info file through the reference's test pipeline."""
    from .data import dataset_index, reference_data

    pkg = reference_data()
    ds = pkg.IndoorDataset(root, ann, dataset_index("scannet"),
                           pipeline=pkg.test_pipeline("scannet"), test_mode=True)
    return ds[k]


def reference_forward(model, sample, cfg, s: int, device, teacher=None) -> dict:
    """The reference's forward over one scene at slot count s (the
    program's group's)."""
    from .data import reference_data

    pkg = reference_data()
    batch, _, pack = pkg.collate([sample], ref_config(cfg, s))
    b, p = pkg.to_device(batch, pack, device)
    return model.scene(b, p, s, teacher)


def unpack(words: torch.Tensor, s: int) -> torch.Tensor:
    """(Q, W) int32 words -> (Q, s) bool, as the program packs them."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    return (((words[..., None] >> shifts) & 1).flatten(-2)[..., :s]).bool()


def mask_flips(bits: torch.Tensor, logits: torch.Tensor, band: float) -> int:
    """Flips of one layer's (Q, n) program bits against the reference's own
    (Q, n) logits of the same set (module docstring)."""
    far_open, far_closed = logits > band, logits < -band
    differ = ((bits & far_closed) | (~bits & far_open)).sum(1)
    whole = bits.all(1)
    reopened = torch.minimum(far_closed.sum(1), far_open.sum(1))
    return int(torch.where(whole, reopened, differ).sum())


def flip_margin(bits: torch.Tensor, logits: torch.Tensor) -> float:
    """The largest |logit| at which one layer's bits and the reference's
    signs disagree, rows the program opened whole read as ``mask_flips``
    reads them: the band below which mask_flips would count (printed, not
    compared)."""
    wrong = torch.where(bits != (logits >= 0), logits.abs(), 0.0).amax(1)
    pos = torch.where(logits >= 0, logits, 0.0).amax(1)
    neg = torch.where(logits < 0, -logits, 0.0).amax(1)
    per_row = torch.where(bits.all(1), torch.minimum(pos, neg), wrong)
    return float(per_row.max()) if per_row.numel() else 0.0


def forward_readings(cls, masks, used, res: dict, band: float) -> dict:
    """fwd_logits_gap, fwd_mask_gap and mask_flips of a forward's last-set
    (Q, C + 1) class and (Q, n) mask logits and its per-layer (Q, n) masks
    against the reference's forward `res`, teacher-forced with them, over
    one scene's valid queries and superpoints; and the flip_margin."""
    sets = list(zip(used, res["masks"][:-1]))
    ref_masks = res["masks"][-1]
    return dict(fwd_logits_gap=rel_gap(cls, res["cls"][-1]),
                fwd_mask_gap=float((masks.float() - ref_masks).norm()) / res["mask_scale"],
                mask_flips=sum(mask_flips(t, logits, band) for t, logits in sets),
                flip_margin=max(flip_margin(t, logits) for t, logits in sets))


def scene_gaps(model, sample, cfg, s: int, prog: dict, band: float, device) -> dict:
    """One scene's forward readings: prog holds the program's (Q_slots, C +
    1) last-set class logits "cls", (Q_slots, S) "masks", per layer (Q_slots,
    W) "bits", (S,) "sp_valid". Returns {input_mismatch (slots), the
    forward_readings, and the valid "rows", "cols"}."""
    n_sem = cfg.num_semantic_queries
    cols = prog["sp_valid"].to(device)
    rows = torch.cat([torch.ones(n_sem, dtype=torch.bool, device=device), cols])
    teacher = [unpack(w.to(device), s)[rows][:, cols] for w in prog["bits"]]
    res = reference_forward(model, sample, cfg, s, device, teacher)
    out = dict(input_mismatch=int((res["valid"] != cols).sum()), rows=rows, cols=cols)
    if out["input_mismatch"]:
        return dict(out, fwd_logits_gap=math.inf, fwd_mask_gap=math.inf, mask_flips=math.inf,
                    flip_margin=math.inf)
    return dict(out, **forward_readings(prog["cls"].to(device)[rows],
                                        prog["masks"].to(device)[rows][:, cols], teacher, res,
                                        band))


def instances_differ(mine, ref) -> int:
    """Instances kept on one side only, or kept on both with another label,
    mask or score (module docstring). mine, ref: [(query, label, score,
    mask)] with queries as compact superpoint indices."""
    a = {(q, l): (s, m) for q, l, s, m in mine}
    b = {(q, l): (s, m) for q, l, s, m in ref}
    bad = len(a.keys() ^ b.keys())
    for key in a.keys() & b.keys():
        (s, m), (rs, rm) = a[key], b[key]
        bad += int(abs(s - rs) > SCORE_TOL * max(1.0, abs(rs)) or not np.array_equal(m, rm))
    return bad


def program_instances(pred: dict, i: int, cols: torch.Tensor) -> list:
    """Scene i's kept instances of the program: [(compact query, label,
    score, mask over the valid superpoints)]."""
    compact = torch.cumsum(cols.long(), 0) - 1
    out = []
    keep = pred["keep"][i].cpu()
    for k in torch.nonzero(keep)[:, 0].tolist():
        q = int(pred["queries"][i, k])
        out.append((int(compact[q]), int(pred["labels"][i, k]), float(pred["scores"][i, k]),
                    pred["masks"][i, k].to(cols.device)[cols].cpu().numpy()))
    return out


def judge(ctx, cfg, groups: list, root: str, ann: str, checked: Checked, band: float) -> dict:
    """{number: reading} (module docstring). groups: the pass's
    (EvalGroup-like) groups in order, with .samples, .scene_ids, .cfg."""
    from ..reference.oneformer3d import plain

    plain.fp32_mode()
    dev = ctx.device
    model = reference_model(cfg, ctx.seed, dev)
    found = dict(input_mismatch=0, fwd_logits_gap=0.0, fwd_mask_gap=0.0, mask_flips=0,
                 post_mismatch=0, flip_margin=0.0)
    for g in checked.sampled:
        group, kept, pred = groups[g], checked.kept.get(g), checked.predictions.get(g)
        if kept is None or pred is None:  # the forward never ran: every reading fails
            return dict(found, input_mismatch=math.inf, ap_gap=math.inf,
                        planted_ap_gap=math.inf)
        s = group.cfg.max_superpoints
        for i, k in enumerate(group.scene_ids):
            sample = reference_scene(root, ann, k)
            valid = kept["valid"][i].cpu().numpy()
            xyz = kept["points"][i].cpu().numpy()[valid]
            if len(xyz) != len(sample["points"]):
                found["input_mismatch"] += max(len(xyz), len(sample["points"]))
                continue
            found["input_mismatch"] += int((sample["points"][:, :3] != xyz).any(1).sum())
            prog = dict(cls=kept["cls"][i], masks=kept["masks"][i], sp_valid=kept["sp_valid"][i],
                        bits=[b[i] for b in kept["bits"]])
            gaps = scene_gaps(model, sample, cfg, s, prog, band, dev)
            for key in ("input_mismatch", "mask_flips"):
                found[key] += gaps[key]
            for key in ("fwd_logits_gap", "fwd_mask_gap", "flip_margin"):
                found[key] = max(found[key], gaps[key])
            rows, cols = gaps["rows"], gaps["cols"]
            inst, sem = plain.predict(
                prog["cls"].to(dev)[rows], prog["masks"].to(dev)[rows][:, cols],
                kept["sp_counts"][i].to(dev)[cols], topk=cfg.topk_insts,
                sp_score_thr=cfg.sp_score_thr, npoint_thr=cfg.npoint_thr,
                score_thr=cfg.inst_score_thr)
            found["post_mismatch"] += instances_differ(program_instances(pred, i, cols), inst)
            found["post_mismatch"] += int((pred["semantic"][i].to(dev)[cols].cpu().numpy()
                                           != sem).sum())
    del model
    scenes = {}
    found["ap_gap"] = ap_gap(groups, root, ann, checked.predictions, checked.results, scenes)
    found["planted_ap_gap"] = planted_ap_gap(groups, root, ann, ctx.seed, dev, scenes)
    return found


def planted_predictions(group, seed: int, device):
    """InstancePredictions over a group's superpoint slots, drawn from each
    scene's ground truth (the reference's ``ground_truth`` of its test-
    pipeline sample) and the seed: per ground-truth instance, the slots its
    points fall in (its class), the same one slot short, the same with
    another class, and its first slot alone (under 100 points: the floor);
    then PLANTED_RANDOM random masks of random classes. Random scores, a
    tenth not kept. The semantic map: each slot's most frequent class, a
    fifth of the slots another class."""
    from unidet3d_tpu_torch.models.instance_postprocess import InstancePredictions

    from ..reference.oneformer3d import plain

    s = group.cfg.max_superpoints
    rng = np.random.default_rng([seed, group.index])
    scenes = []
    for sample in group.samples:
        sp = np.minimum(np.asarray(sample["sp_pts_mask"], np.int64), s - 1)
        sem, gt_ids = plain.ground_truth(sample["pts_semantic_mask"],
                                         sample["pts_instance_mask"])
        masks, labels = [], []
        for gid in np.unique(gt_ids[gt_ids > 0]):
            slots = np.unique(sp[gt_ids == gid])
            label = int(gid) // 1000 - 1
            whole = np.zeros(s, bool)
            whole[slots] = True
            short = whole.copy()
            short[slots[-1]] = len(slots) == 1
            first = np.zeros(s, bool)
            first[slots[0]] = True
            masks += [whole, short, whole, first]
            labels += [label, label, (label + 1) % plain.N_INST, label]
        for _ in range(PLANTED_RANDOM):
            masks.append(rng.random(s) < PLANTED_DENSITY)
            labels.append(int(rng.integers(plain.N_INST)))
        counts = np.bincount(sp * (plain.N_SEM + 1) + sem, minlength=s * (plain.N_SEM + 1))
        semantic = counts.reshape(s, plain.N_SEM + 1)[:, :plain.N_SEM].argmax(1)
        other = rng.random(s) < 0.2
        semantic[other] = rng.integers(plain.N_SEM, size=int(other.sum()))
        scenes.append((np.stack(masks), np.asarray(labels), semantic))
    k = max(len(m) for m, _, _ in scenes)
    masks = np.zeros((len(scenes), k, s), bool)
    labels = np.zeros((len(scenes), k), np.int64)
    keep = np.zeros((len(scenes), k), bool)
    for i, (m, lab, _) in enumerate(scenes):
        masks[i, :len(m)], labels[i, :len(m)] = m, lab
        keep[i, :len(m)] = rng.random(len(m)) >= 0.1
    scores = rng.random((len(scenes), k)).astype(np.float32)
    semantic = np.stack([sem for _, _, sem in scenes])
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)  # noqa: E731
    return InstancePredictions(masks=t(masks), labels=t(labels), scores=t(scores), keep=t(keep),
                               queries=t(np.zeros_like(labels)), semantic=t(semantic))


def planted_ap_gap(groups: list, root: str, ann: str, seed: int, device,
                   scenes: dict | None = None) -> float:
    """ap_gap over each group's ``planted_predictions``, counted and drained
    by the program's eval loop functions into a new InstanceSegMetric."""
    from unidet3d_tpu_torch.train import loop
    from unidet3d_tpu_torch.train.instance_metric import InstanceSegMetric, count_group

    metric, predictions = InstanceSegMetric(), {}
    for g, group in enumerate(groups):
        pred = planted_predictions(group, seed, device)
        loop.drain(metric, (count_group(pred, group.samples), group))
        predictions[g] = pred._asdict()
    return ap_gap(groups, root, ann, predictions, metric.compute(logger=None), scenes)


def ap_gap(groups: list, root: str, ann: str, predictions: dict, results: dict,
           scenes: dict | None = None) -> float:
    """The reference's per-point metric of the instances `predictions`
    ({group index: the group's predictions}) over the pass against the
    program's numbers `results`. `scenes` caches the reference's scenes by
    index."""
    from ..reference.oneformer3d import plain

    scenes = {} if scenes is None else scenes
    inst_scenes, sem_scenes = [], []
    for g, group in enumerate(groups):
        pred = predictions.get(g)
        if pred is None:
            return math.inf
        s = group.cfg.max_superpoints
        for i, k in enumerate(group.scene_ids):
            if k not in scenes:
                scenes[k] = reference_scene(root, ann, k)
            sample = scenes[k]
            sp = np.minimum(np.asarray(sample["sp_pts_mask"], np.int64), s - 1)
            sem_gt, gt_ids = plain.ground_truth(sample["pts_semantic_mask"],
                                                sample["pts_instance_mask"])
            keep = pred["keep"][i].cpu().numpy()
            masks = pred["masks"][i].cpu().numpy()
            labels = pred["labels"][i].cpu().numpy()
            scores = pred["scores"][i].cpu().numpy()
            inst_scenes.append(([(int(labels[k2]) + 1, scores[k2], masks[k2][sp])
                                 for k2 in np.flatnonzero(keep)], gt_ids))
            sem_scenes.append((pred["semantic"][i].cpu().numpy()[sp], sem_gt))
    want = plain.scannet_eval(inst_scenes)
    want_sem = plain.semantic_eval(sem_scenes)
    mine = next(iter(results.values()), {})
    pairs = [("AP", want["all_ap"]), ("AP50", want["all_ap_50%"]), ("AP25", want["all_ap_25%"]),
             ("mIoU", want_sem["miou"]), ("acc", want_sem["acc"]),
             ("acc_cls", want_sem["acc_cls"])]
    for c, name in enumerate(plain.SEMANTIC_CLASSES[plain.N_STUFF:]):
        pairs += [(f"{name}_AP", want["classes"][c][0]), (f"{name}_AP50", want["classes"][c][1]),
                  (f"{name}_AP25", want["classes"][c][2])]
    pairs += [(f"{name}_IoU", want_sem["iou"][c])
              for c, name in enumerate(plain.SEMANTIC_CLASSES)]
    gap = 0.0
    for key, value in pairs:
        other = mine.get(key)
        if other is None or math.isnan(value) != math.isnan(other):
            return math.inf
        if not math.isnan(value):
            gap = max(gap, abs(value - other))
    if set(mine) - {k for k, _ in pairs}:
        return math.inf  # a number of the program's that the reference does not read
    return gap
