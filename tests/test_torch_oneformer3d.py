"""OneFormer3D on the port (``models/oneformer3d.py``, ``ops/mask_attention.py``,
``models/instance_postprocess.py``, ``train/instance_metric.py``) against the
plain fp32 reference (``reference/oneformer3d_plain.py``) on the CPU, at a
small size on seeded random weights: the decoder teacher-forced with the
port's own attention masks and free-running, the reopen rule, M1's plain
version against a dense masked softmax, matrix NMS against an O(n^2) loop,
the histogram metric against ScanNet's per-point evaluation (exactly), and
``evaluate`` / ``tools/test.py`` on a tiny OneFormer3D configuration."""
import dataclasses
import math

import numpy as np
import pytest
import torch

from benchmark.harness.weights import init_from_seed_
from benchmark.reference.refnet.data import batcher as ref_batcher
from reference import oneformer3d_plain as ref
from unidet3d_tpu_torch.core.config import OneFormer3DConfig
from unidet3d_tpu_torch.core.experiment import DatasetSpec, ExperimentConfig
from unidet3d_tpu_torch.data import batcher
from unidet3d_tpu_torch.data.datasets import IndoorDataset
from unidet3d_tpu_torch.data import pipelines
from unidet3d_tpu_torch.data.synthetic import (stripe_superpoints, synthetic_scene,
                                               write_info_dataset)
from unidet3d_tpu_torch.models.instance_postprocess import matrix_nms, predict_instances
from unidet3d_tpu_torch.models.oneformer3d import OneFormer3D, attention_bits
from unidet3d_tpu_torch.ops.mask_attention import (mask_attention_cuda, mask_attention_plain,
                                                   pack_bits, unpack_bits)
from unidet3d_tpu_torch.train import loop
from unidet3d_tpu_torch.train.instance_metric import (InstanceSegMetric, ground_truth,
                                                      group_counts, group_histograms)

PLANES = (8, 16, 24)
TINY = OneFormer3DConfig(num_planes=PLANES, num_channels=8, d_model=32, num_heads=1,
                         hidden_dim=32, num_layers=2, max_points=4096, voxel_capacity=16384,
                         max_superpoints=256, max_gts=16, topk_insts=120,
                         compute_dtype="float32")
REF_DECODER = dict(num_layers=2, d_model=32, num_heads=1, hidden_dim=32)
STRIPE = 16  # points per superpoint
DET_IDS = (3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36, 39)


def scannet_scene(name, n, seed, n_inst=10, sp_per_inst=8):
    """A scene in ScanNet's raw format: nyu40 semantic ids, raw instance ids
    (-1: none), stripe superpoints; instance k spans sp_per_inst stripes
    (the last two instances one stripe: under 100 points), the rest is wall
    and floor, with a few unannotated (nyu40 0) points."""
    rng = np.random.RandomState(seed)
    pts = synthetic_scene(n, seed=seed)
    sp = stripe_superpoints(pts, STRIPE)
    spans = [sp_per_inst] * (n_inst - 2) + [1, 1]
    inst_of_sp = np.full(sp.max() + 1, -1)
    at = 0
    for k, w in enumerate(spans):
        inst_of_sp[at:at + w] = 3 * k + 1  # sparse raw ids
        at += w
    inst = inst_of_sp[sp]
    labels = rng.randint(0, 18, n_inst)
    sem = rng.randint(1, 3, n)  # wall, floor
    sem[rng.rand(n) < 0.05] = 0  # unannotated
    thing = inst >= 0
    sem[thing] = np.asarray(DET_IDS)[labels[(inst[thing] - 1) // 3]]
    raw = pts.copy()
    raw[:, 3:] = (pts[:, 3:] + 1) * 127.5
    return dict(name=name, points=raw, super_points=sp, instance_mask=inst,
                semantic_mask=sem, axis_align_matrix=np.eye(4))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("of3d") / "scannet")
    write_info_dataset(path, [scannet_scene(f"s{i}", n, 40 + i)
                              for i, n in enumerate((2600, 2000, 3100, 1700, 2300))],
                       ann_file="infos_val.pkl")
    return path


def samples_of(root):
    ds = IndoorDataset(root, "infos_val.pkl", 0, pipeline=pipelines.test_pipeline("scannet"),
                       test_mode=True)
    return [ds[i] for i in range(len(ds))]


@pytest.fixture(scope="module")
def program(root):
    torch.manual_seed(0)
    model = init_from_seed_(OneFormer3D(TINY, device="cpu"), 5)
    samples = samples_of(root)[:2]
    batch, _, pack = batcher.collate(samples, TINY)
    b, p = batcher.to_device(batch, pack, "cpu")
    with torch.no_grad():
        out, aux = model(b, p)
    return samples, out, aux


def reference_model():
    return init_from_seed_(ref.Reference(num_planes=PLANES, **REF_DECODER), 5).eval()


def reference_scene(model, sample, teacher=None):
    batch, _, pack = ref_batcher.collate([sample], TINY)
    b, p = ref_batcher.to_device(batch, pack, "cpu")
    return model.scene(b, p, TINY.max_superpoints, teacher)


def rows_cols(aux, i):
    valid = aux.sp_valid[i]
    rows = torch.cat([torch.ones(TINY.num_semantic_queries, dtype=torch.bool), valid])
    return rows, valid


def rel(a, b):
    return float((a - b).norm() / b.norm())


def test_decoder_matches_reference_teacher_forced(program):
    samples, out, aux = program
    model = reference_model()
    for i, sample in enumerate(samples):
        rows, cols = rows_cols(aux, i)
        teacher = [unpack_bits(bits[i:i + 1], TINY.max_superpoints)[0][rows][:, cols]
                   for bits in aux.attn_bits]
        res = reference_scene(model, sample, teacher)
        assert torch.equal(res["valid"], aux.sp_valid[i])
        assert rel(out.cls_logits[-1, i][rows], res["cls"][-1]) < 1e-4
        assert rel(out.masks[i][rows][:, cols], res["masks"][-1]) < 1e-4
        for used, logits in zip(teacher, res["masks"][:-1]):  # the port's bits are its signs
            own = logits >= 0
            own[~own.any(1)] = True
            agree = (own == used) | (logits.abs() < 1e-4)
            assert bool(agree.all())
        # The post-processing on the port's own outputs keeps what the
        # reference keeps from them.
        pred = predict_instances(TINY, out.cls_logits[-1, i:i + 1], out.masks[i:i + 1],
                                 aux.sp_valid[i:i + 1], aux.sp_counts[i:i + 1])
        inst, sem = ref.predict(out.cls_logits[-1, i][rows], out.masks[i][rows][:, cols],
                                aux.sp_counts[i][cols], topk=TINY.topk_insts)
        slots = torch.nonzero(cols)[:, 0]
        mine = [(int(q), int(l), float(s), m[cols].numpy()) for q, l, s, m, k in zip(
            pred.queries[0], pred.labels[0], pred.scores[0], pred.masks[0], pred.keep[0]) if k]
        assert len(mine) == len(inst) > 0
        for (q, l, s, m), (rq, rl, rs, rm) in zip(mine, inst):
            assert (q, l) == (int(slots[rq]), rl)
            assert s == pytest.approx(rs, rel=1e-5)
            assert np.array_equal(m, rm)
        assert np.array_equal(pred.semantic[0][cols].numpy(), sem)


def test_decoder_free_running_matches_reference(program):
    samples, out, aux = program
    model = reference_model()
    for i, sample in enumerate(samples):
        rows, cols = rows_cols(aux, i)
        res = reference_scene(model, sample)
        assert rel(out.cls_logits[-1, i][rows], res["cls"][-1]) < 1e-4
        assert rel(out.masks[i][rows][:, cols], res["masks"][-1]) < 1e-4
        for bits, used in zip(aux.attn_bits, res["used"]):
            assert torch.equal(unpack_bits(bits[i:i + 1], TINY.max_superpoints)[0][rows][:, cols],
                               used)


def test_reopen_rule_and_open_pairs():
    logits = torch.tensor([[[1.0, -1.0, 2.0, 5.0],  # open at keys 0, 2 (3 padded)
                            [-1.0, -2.0, -3.0, 4.0],  # closed on the valid keys: reopened
                            [0.0, -0.0, -1e-9, 1.0],  # the sign test: >= 0 is open
                            [3.0, 3.0, 3.0, 3.0]]])  # an invalid row stays closed
    key_valid = torch.tensor([[True, True, True, False]])
    query_valid = torch.tensor([[True, True, True, False]])
    bits, pairs = attention_bits(logits, key_valid, query_valid)
    got = unpack_bits(bits, 4)[0]
    want = torch.tensor([[1, 0, 1, 0], [1, 1, 1, 0], [1, 1, 0, 0], [0, 0, 0, 0]], dtype=torch.bool)
    assert torch.equal(got, want)
    assert int(pairs) == 2 + 3 + 2


def test_pack_bits_round_trip_and_bit_31():
    rng = torch.Generator().manual_seed(1)
    mask = torch.rand((2, 5, 70), generator=rng) < 0.5
    mask[0, 0, 31] = True
    words = pack_bits(mask)
    assert words.shape == (2, 5, 3) and words.dtype == torch.int32
    assert torch.equal(unpack_bits(words, 70), mask)
    assert int(words[0, 0, 0]) < 0  # bit 31 is the sign of the int32 word
    assert not unpack_bits(words, 96)[..., 70:].any()


def dense_masked_softmax(q, k, v, mask):
    """softmax over the open keys, zero rows where none is open."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.double(), k.double()) / math.sqrt(q.shape[-1])
    s = s.masked_fill(~mask[:, None], float("-inf"))
    p = torch.softmax(s, -1).nan_to_num(0.0)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.double())


@pytest.mark.parametrize("lq,lk", [(45, 70), (70, 45), (64, 64)])
def test_mask_attention_plain_matches_dense_masked_softmax(lq, lk):
    rng = torch.Generator().manual_seed(lq * 100 + lk)
    b, h, d = 2, 3, 32
    q, k, v = (torch.randn((b, h, n, d), generator=rng) for n in (lq, lk, lk))
    mask = torch.rand((b, lq, lk), generator=rng) < 0.3
    mask[0, 3] = False  # a closed row
    q_len = torch.tensor([lq, lq - 7], dtype=torch.int32)
    k_len = torch.tensor([lk - 5, lk], dtype=torch.int32)  # padded keys
    mask[0, :, lk - 5:] = True  # open bits past k_len are not read
    want_mask = mask.clone()
    want_mask[0, :, lk - 5:] = False
    want_mask[1, lq - 7:] = False
    want = dense_masked_softmax(q, k, v, want_mask).float()
    got = mask_attention_plain(q, k, v, pack_bits(mask), q_len, k_len, 1 / math.sqrt(d))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert not got[0, :, 3].any() and not got[1, :, lq - 7:].any()
    assert torch.equal(mask_attention_cuda(q, k, v, pack_bits(mask), q_len, k_len,
                                           1 / math.sqrt(d)), got)  # CPU: the plain version


def matrix_nms_loop(masks, labels, scores):
    """The linear-kernel matrix NMS written as loops over pairs: (decayed
    scores, labels, input rows), in descending order of the decayed
    scores."""
    order = sorted(range(len(scores)), key=lambda i: -float(scores[i]))
    m = [masks[i].double() for i in order]
    lab = [int(labels[i]) for i in order]
    n = len(order)
    iou = [[0.0] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1, n):
            inter = float((m[i] * m[j]).sum())
            union = float(m[i].sum() + m[j].sum()) - inter
            iou[i][j] = inter / union if lab[i] == lab[j] else 0.0
    comp = [max([iou[i][j] for i in range(n)]) for j in range(n)]
    decay = [min((1 - iou[i][j]) / (1 - comp[i]) for i in range(n)) for j in range(n)]
    decayed = [float(scores[order[j]]) * decay[j] for j in range(n)]
    again = sorted(range(n), key=lambda j: -decayed[j])  # mmdet's second sort
    return ([decayed[j] for j in again], [lab[j] for j in again],
            [order[j] for j in again])


def test_matrix_nms_matches_pairwise_loop():
    rng = torch.Generator().manual_seed(3)
    masks = torch.rand((2, 24, 50), generator=rng) ** 3
    labels = torch.randint(0, 3, (2, 24), generator=rng)
    scores = torch.rand((2, 24), generator=rng)
    got_scores, got_labels, got_masks, order = matrix_nms(masks, labels, scores)
    for i in range(2):
        want_scores, want_labels, want_rows = matrix_nms_loop(masks[i], labels[i], scores[i])
        assert order[i].tolist() == want_rows and got_labels[i].tolist() == want_labels
        np.testing.assert_allclose(got_scores[i].numpy(), want_scores, rtol=1e-5, atol=1e-7)
        assert torch.equal(got_masks[i], masks[i][order[i]])
        assert (got_scores[i][:-1] >= got_scores[i][1:]).all()


def predictions(rng, hist, gt_labels, k=40):
    """k predictions over a scene's superpoints: each ground-truth instance
    (its superpoints, its label) twice, the copy one superpoint short and
    some with another label, then random masks."""
    n_sp = hist.shape[0]
    masks = rng.rand(k, n_sp) < rng.uniform(0.02, 0.4, (k, 1))
    labels = rng.randint(0, 18, k)
    for g, label in enumerate(gt_labels[: k // 2 - 1]):
        sps = np.flatnonzero(hist[:, 1 + g])
        masks[2 * g] = masks[2 * g + 1] = False
        masks[2 * g, sps] = True
        masks[2 * g + 1, sps[1:]] = True
        labels[2 * g] = labels[2 * g + 1] = label if g % 4 else (label + 1) % 18
    return masks, labels, rng.rand(k).astype(np.float32), rng.rand(k) < 0.9


@pytest.mark.parametrize("seed", [7, 8, 9])
def test_histogram_metric_equals_per_point_scannet_evaluation(root, seed):
    rng = np.random.RandomState(seed)
    samples = samples_of(root)
    s = 256
    metric = InstanceSegMetric()
    inst_scenes, sem_scenes = [], []
    for sample in samples:
        n_sp = int(sample["sp_pts_mask"].max()) + 1
        hists = group_histograms([sample], s, "cpu")
        gt_sizes, gt_labels, present = ground_truth(hists.hist[0].sum(0).numpy(),
                                                    hists.label_lo[0].numpy(),
                                                    hists.label_hi[0].numpy())
        hist = hists.hist[0][:, present].numpy()
        masks, labels, scores, keep = predictions(rng, hist[:n_sp], gt_labels)
        majority = np.argmax(hists.sem_hist[0, :n_sp, :20].numpy(), 1)
        semantic = np.where(rng.rand(n_sp) < 0.5, majority, rng.randint(0, 20, n_sp))
        padded = np.zeros((1, len(keep), s), bool)
        padded[0, :, :n_sp] = masks
        sem_pad = np.zeros((1, s), np.int64)
        sem_pad[0, :n_sp] = semantic
        inter, conf = group_counts(torch.from_numpy(padded), torch.from_numpy(sem_pad), hists)
        metric.process(keep, labels, scores, inter[0][:, present].numpy(), gt_sizes, gt_labels,
                       conf[0].numpy())
        sp = sample["sp_pts_mask"]
        sem_gt, gt_ids = ref.ground_truth(sample["pts_semantic_mask"], sample["pts_instance_mask"])
        inst_scenes.append(([(int(l) + 1, sc, m[sp]) for m, l, sc, k in
                             zip(masks, labels, scores, keep) if k], gt_ids))
        sem_scenes.append((semantic[sp], sem_gt))
    mine = metric.compute(logger=None)["scannet"]
    want = ref.scannet_eval(inst_scenes)
    want_sem = ref.semantic_eval(sem_scenes)
    assert 0 < mine["AP"] < mine["AP25"] < 1 and 0 < mine["mIoU"] < 1
    pairs = [(mine["AP"], want["all_ap"]), (mine["AP50"], want["all_ap_50%"]),
             (mine["AP25"], want["all_ap_25%"]), (mine["mIoU"], want_sem["miou"]),
             (mine["acc"], want_sem["acc"]), (mine["acc_cls"], want_sem["acc_cls"])]
    names = [n for n in mine if n.endswith(("_AP", "_AP50", "_AP25"))]
    assert len(names) == 3 * 18
    pairs += [(mine[n], want["classes"][i // 3][i % 3]) for i, n in enumerate(names)]
    pairs += [(mine[f"{n}_IoU"], v) for n, v in zip(ref.SEMANTIC_CLASSES, want_sem["iou"])]
    for a, b in pairs:
        assert (math.isnan(a) and math.isnan(b)) or a == b, (a, b)


def test_histograms_count_the_void_small_instances_and_folded_superpoints():
    sample = dict(pts_semantic_mask=np.array([5, 5, 5, 1, 0, 39, 39, 5, 2]),
                  pts_instance_mask=np.array([2, 2, 2, -1, 4, 7, 7, 2, 9]),
                  sp_pts_mask=np.array([0, 0, 1, 1, 2, 3, 9, 9, 2]))
    hists = group_histograms([sample], 4, "cpu")  # superpoint 9 folds into slot 3
    sizes, labels, present = ground_truth(hists.hist[0].sum(0).numpy(),
                                          hists.label_lo[0].numpy(), hists.label_hi[0].numpy())
    # Raw id 4 is unannotated (nyu40 0) and 9 a floor: void, as is the wall point.
    assert sizes.tolist() == [4, 2] and labels.tolist() == [2, 17]
    assert hists.hist[0][:, present].tolist() == [[0, 2, 0], [1, 1, 0], [2, 0, 0], [0, 1, 2]]
    assert hists.sem_hist[0, 3].tolist()[19] == 2 and hists.sem_hist[0, 2].tolist()[20] == 1
    mixed = dict(sample, pts_semantic_mask=np.array([5, 6, 5, 1, 0, 39, 39, 5, 2]))
    h = group_histograms([mixed], 4, "cpu")
    with pytest.raises(ValueError, match="several semantic classes"):
        ground_truth(h.hist[0].sum(0).numpy(), h.label_lo[0].numpy(), h.label_hi[0].numpy())


def experiment(root, work_dir="work_dirs/of3d_tiny"):
    return ExperimentConfig(model=TINY, datasets=(DatasetSpec(
        name="scannet", data_root=root, ann_val="infos_val.pkl"),), eval_batch_size=2,
        work_dir=work_dir)


def test_evaluate_runs_oneformer3d_and_equals_the_groups_by_hand(root):
    exp = experiment(root)
    model, table = loop.build_model(exp, device="cpu")
    assert table is None and isinstance(model, OneFormer3D)
    init_from_seed_(model, 11)
    res = loop.evaluate(exp, model, device="cpu", logger=lambda *a: None, num_threads=1)
    assert {"AP", "AP50", "AP25", "mIoU"} <= set(res["scannet"])
    # The same groups by hand: the loader's order (largest scenes first).
    ds = IndoorDataset(root, "infos_val.pkl", 0, pipeline=pipelines.test_pipeline("scannet"),
                       test_mode=True)
    order = np.argsort([-ds.scene_size(i) for i in range(len(ds))], kind="stable")
    metric = InstanceSegMetric()
    for lo in range(0, len(order), 2):
        idxs = [int(order[min(j, len(order) - 1)]) for j in range(lo, lo + 2)]
        samples = [ds[i] for i in idxs]
        batch, _, pack = batcher.collate(samples, TINY)
        group = loop.EvalGroup(samples, *batcher.to_device(batch, pack, "cpu"), TINY, 0, 0,
                               sorted(set(idxs), key=idxs.index))
        loop.drain(metric, loop.eval_group(model, metric, group))
    want = metric.compute(logger=None)["scannet"]
    for key, value in want.items():
        assert (math.isnan(value) and math.isnan(res["scannet"][key])) or \
            value == res["scannet"][key], key
    with pytest.raises(ValueError, match="draw boxes"):
        loop.evaluate(exp, model, device="cpu", show_dir="x")
    with pytest.raises(NotImplementedError):
        loop.train(exp, device="cpu")


def test_test_cli_evaluates_oneformer3d(root, tmp_path, capsys):
    from unidet3d_tpu_torch.tools import test as test_cli
    from unidet3d_tpu_torch.train.checkpoint import CheckpointManager

    cfg = tmp_path / "of3d_tiny.py"
    cfg.write_text(
        "from unidet3d_tpu_torch.core.config import OneFormer3DConfig\n"
        "from unidet3d_tpu_torch.core.experiment import DatasetSpec, ExperimentConfig\n"
        f"TINY = {TINY!r}\n"
        "def get_config():\n"
        "    return ExperimentConfig(model=TINY, datasets=(DatasetSpec(name='scannet', "
        f"data_root={root!r}, ann_val='infos_val.pkl'),), eval_batch_size=2, "
        f"work_dir={str(tmp_path)!r})\n")
    exp = experiment(root)
    model, _ = loop.build_model(exp, device="cpu")
    init_from_seed_(model, 11)
    CheckpointManager(str(tmp_path / "checkpoints")).save(
        3, model, torch.optim.SGD(model.parameters(), lr=0.0))
    res = test_cli.main([str(cfg), str(tmp_path / "checkpoints"), "--device", "cpu"])
    want = loop.evaluate(exp, model, device="cpu", logger=lambda *a: None, num_threads=1)
    assert res.keys() == want.keys()
    for key, value in want["scannet"].items():
        got = res["scannet"][key]
        assert (math.isnan(value) and math.isnan(got)) or value == got, key
    assert "scannet: AP=" in capsys.readouterr().out


def test_config_is_the_public_ones_test_cfg():
    from unidet3d_tpu_torch.configs.oneformer3d_scannet import get_config

    cfg = get_config().model
    assert dataclasses.asdict(cfg) == dataclasses.asdict(OneFormer3DConfig())
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.hidden_dim) == (6, 256, 8, 1024)
    assert cfg.num_planes == (32, 64, 96, 128, 160) and cfg.voxel_size == 0.02
    assert (cfg.topk_insts, cfg.inst_score_thr, cfg.npoint_thr, cfg.sp_score_thr) == (
        600, 0.0, 100, 0.4)
    assert cfg.obj_normalization and cfg.nms and cfg.matrix_nms_kernel == "linear"
    assert cfg.max_superpoints == 3072
