"""The port's data parallelism (``parallel/distributed.py``) on the CPU: 2
ranks over ``gloo``, spawned with ``torch.multiprocessing`` and meeting at a
``FileStore`` in the test's temporary directory, one intra-op thread each,
joined with a timeout so that a hang fails the test:

  (a) masked SyncBN, 2 ranks x half the rows, against the JAX package's
      ``MaskedBatchNorm(axis_name="data")`` under ``shard_map`` on 2 of the
      8 virtual CPU devices (its backward is ``jax.vjp`` through ``psum``'s
      transpose): output, running statistics and the gradients of x, weight
      and bias, also with a rank that has no valid row;
  (b) ``criterion`` with the group's count against JAX's
      ``criterion(axis_name="data")`` under ``shard_map``: each rank's loss
      and gradients, with a rank whose scenes have no pairs;
  (c) the whole training step (``make_train_step``) at the small config of
      ``test_torch_train_slice.py``: 2 ranks x 2 scenes against the one-
      process step on the 4 scenes, loss, every gradient by name and the
      running statistics, and the parameters bit-equal across ranks after
      the step. The one-process step is the yardstick here because
      ``test_torch_train_slice.py`` holds it against the JAX step (a JAX
      step over a 2-device mesh as a third side would take this file past
      its time budget: one more jit of the whole model);
  (d) ``train()`` in 2 ranks, 1 epoch x 2 steps on on-disk datasets, then
      ``resume="auto"`` with 2 epochs;
and ``maybe_initialize``'s backend choice and its raise when WORLD_SIZE > 1
and initialisation fails. The JAX references run in the test's process
only: the ranks import neither JAX nor the JAX package.
"""
import logging
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from unidet3d_tpu_torch.parallel import distributed as pdist

WORLD = 2
JOIN_TIMEOUT_S = 120


def _entry(rank, world, store_path, out_dir, fn, args):
    """A rank: join the gloo group at the FileStore, run fn(rank, world,
    *args), save its result as rank<r>.pt."""
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        result = fn(rank, world, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))


def run_ranks(tmp_path, fn, *args, world=WORLD):
    """fn(rank, world, *args) in `world` spawned ranks; their results by
    rank. A rank's error fails the call; ranks still running after
    JOIN_TIMEOUT_S are killed and the call fails."""
    out = tmp_path / f"ranks_{fn.__name__}"
    out.mkdir()
    ctx = mp.spawn(_entry, args=(world, str(out / "store"), str(out), fn, args),
                   nprocs=world, join=False)
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{fn.__name__}: ranks still running after {JOIN_TIMEOUT_S} s")
    assert not any(p.is_alive() for p in ctx.processes)
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(world)]


def _jax_mesh():
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:WORLD]), ("data",))


# ---------------------------------------------------------------- (a) SyncBN

C = 5
ROWS = 12  # per rank


def _bn_inputs(seed, empty_rank):
    rng = np.random.RandomState(seed)
    x = (rng.randn(WORLD * ROWS, C) * 2 + 1).astype(np.float32)
    mask = rng.rand(WORLD * ROWS) < 0.7
    if empty_rank is not None:
        mask[empty_rank * ROWS:(empty_rank + 1) * ROWS] = False
    ct = rng.randn(WORLD * ROWS, C).astype(np.float32)
    return dict(x=x, mask=mask, ct=ct, weight=rng.uniform(0.5, 1.5, C).astype(np.float32),
                bias=rng.randn(C).astype(np.float32),
                mean=rng.randn(C).astype(np.float32),
                var=rng.uniform(0.5, 1.5, C).astype(np.float32))


def _bn_rank(rank, world, cases):
    from unidet3d_tpu_torch.models.norm import MaskedBatchNorm

    out = []
    for inp in cases:
        rows = slice(rank * ROWS, (rank + 1) * ROWS)
        bn = MaskedBatchNorm(C)
        with torch.no_grad():
            for name in ("weight", "bias"):
                getattr(bn, name).copy_(torch.from_numpy(inp[name]))
            bn.running_mean.copy_(torch.from_numpy(inp["mean"]))
            bn.running_var.copy_(torch.from_numpy(inp["var"]))
        x = torch.from_numpy(inp["x"][rows]).requires_grad_(True)
        y = bn(x, torch.from_numpy(inp["mask"][rows]), train=True)
        (y * torch.from_numpy(inp["ct"][rows])).sum().backward()
        out.append(dict(y=y.detach(), x_grad=x.grad, weight_grad=bn.weight.grad,
                        bias_grad=bn.bias.grad, mean=bn.running_mean.clone(),
                        var=bn.running_var.clone()))
    return out


def _bn_jax(inp):
    """JAX's SyncBN under shard_map: y and x's cotangent by rows, the
    running statistics, and the parameters' cotangents summed over the
    devices (the gradient of the sum of the devices' losses)."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from unidet3d_tpu.models.norm import MaskedBatchNorm

    bn = MaskedBatchNorm(features=C, axis_name="data")
    params = {"scale": jnp.asarray(inp["weight"]), "bias": jnp.asarray(inp["bias"])}
    stats = {"mean": jnp.asarray(inp["mean"]), "var": jnp.asarray(inp["var"])}

    def local(params, x, mask, ct):
        def fwd(params, x):
            return bn.apply({"params": params, "batch_stats": stats}, x, mask, False,
                            mutable=["batch_stats"])

        (y, mut), vjp = jax.vjp(fwd, params, x)
        zero_stats = jax.tree_util.tree_map(jnp.zeros_like, mut)
        g_params, g_x = vjp((ct, zero_stats))
        return y, mut["batch_stats"], jax.lax.psum(g_params, "data"), g_x

    fn = shard_map(local, mesh=_jax_mesh(),
                   in_specs=(P(), P("data"), P("data"), P("data")),
                   out_specs=(P("data"), P(), P(), P("data")), check_vma=False)
    y, st, gp, gx = jax.jit(fn)(params, jnp.asarray(inp["x"]), jnp.asarray(inp["mask"]),
                               jnp.asarray(inp["ct"]))
    return dict(y=np.asarray(y), x_grad=np.asarray(gx), weight_grad=np.asarray(gp["scale"]),
                bias_grad=np.asarray(gp["bias"]), mean=np.asarray(st["mean"]),
                var=np.asarray(st["var"]))


BN_CASES = {"both ranks with rows": None, "rank 1 without valid rows": 1}


@pytest.fixture(scope="module")
def bn_runs(tmp_path_factory):
    cases = [_bn_inputs(10 + i, empty) for i, empty in enumerate(BN_CASES.values())]
    return cases, run_ranks(tmp_path_factory.mktemp("bn"), _bn_rank, cases)


@pytest.mark.parametrize("case", list(BN_CASES))
def test_sync_bn_matches_jax_psum_and_its_transpose(bn_runs, case):
    cases, ranks = bn_runs
    i = list(BN_CASES).index(case)
    ref = _bn_jax(cases[i])
    mine = [r[i] for r in ranks]
    # fp32; the moments' sums in another order (per rank, then the group).
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(torch.cat([m["y"] for m in mine]).numpy(), ref["y"], **tol)
    np.testing.assert_allclose(torch.cat([m["x_grad"] for m in mine]).numpy(), ref["x_grad"],
                               **tol)
    for name in ("weight_grad", "bias_grad"):
        np.testing.assert_allclose((mine[0][name] + mine[1][name]).numpy(), ref[name], **tol,
                                   err_msg=name)
    for name in ("mean", "var"):
        assert torch.equal(mine[0][name], mine[1][name]), name
        np.testing.assert_allclose(mine[0][name].numpy(), ref[name], **tol, err_msg=name)


# ------------------------------------------------------------- (b) criterion

B_SCENES = 4  # 2 per rank


def _criterion_inputs():
    from tests.test_torch_criterion import _problem

    prob = _problem(5, b=B_SCENES)
    prob["gt_valid"][2:] = False  # rank 1's scenes: no ground truth, no pairs
    flags = dict(rotated=np.zeros(B_SCENES, bool), topk=np.array([6, 3, 6, 3], np.int32),
                 weights=np.array([1.0, 0.7, 1.0, 0.5], np.float32))
    return prob, flags


def _criterion_rank(rank, world, prob, flags):
    from unidet3d_tpu_torch.losses import criterion as tcrit

    s = slice(rank * 2, (rank + 1) * 2)

    def t(x, batch_axis=0):
        return torch.from_numpy(np.ascontiguousarray(x[(slice(None),) * batch_axis + (s,)]))

    logits = t(prob["logits"], 1).requires_grad_(True)
    boxes = t(prob["boxes"], 1).requires_grad_(True)
    gt = tcrit.SceneGT(labels=t(prob["labels"]), boxes=t(prob["gt_boxes"]),
                       valid=t(prob["gt_valid"]), query_masks=t(prob["query_masks"]))
    loss = tcrit.criterion(logits, boxes, t(prob["query_valid"]), gt, t(flags["rotated"]),
                           t(flags["topk"]), t(flags["weights"]), rotated_scenes=())
    loss.backward()
    return dict(loss=loss.detach(), logits_grad=logits.grad, boxes_grad=boxes.grad)


def _criterion_jax(prob, flags):
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from tests.test_torch_criterion import _jax_gt
    from unidet3d_tpu.losses.criterion import criterion as jax_criterion

    def local(logits, boxes, query_valid, gt, rotated, topk, weights):
        def loss(logits, boxes):
            return jax_criterion(logits, boxes, query_valid, gt, rotated, topk, weights,
                                 axis_name="data")

        value, grads = jax.value_and_grad(loss, argnums=(0, 1))(logits, boxes)
        return value[None], *grads

    d, l1 = P("data"), P(None, "data")
    fn = shard_map(local, mesh=_jax_mesh(), in_specs=(l1, l1, d, d, d, d, d),
                   out_specs=(d, l1, l1), check_vma=False)
    losses, g_logits, g_boxes = jax.jit(fn)(
        jnp.asarray(prob["logits"]), jnp.asarray(prob["boxes"]),
        jnp.asarray(prob["query_valid"]), _jax_gt(prob), jnp.asarray(flags["rotated"]),
        jnp.asarray(flags["topk"]), jnp.asarray(flags["weights"]))
    return np.asarray(losses), np.asarray(g_logits), np.asarray(g_boxes)


def test_criterion_global_count_matches_jax(tmp_path):
    prob, flags = _criterion_inputs()
    ranks = run_ranks(tmp_path, _criterion_rank, prob, flags)
    losses, g_logits, g_boxes = _criterion_jax(prob, flags)
    for r, mine in enumerate(ranks):
        s = slice(r * 2, (r + 1) * 2)
        # fp32 both sides; softmax and DIoU in another order of operations
        # (as test_torch_criterion.py's bounds).
        np.testing.assert_allclose(float(mine["loss"]), losses[r], rtol=1e-5)
        np.testing.assert_allclose(mine["logits_grad"].numpy(), g_logits[:, s], rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(mine["boxes_grad"].numpy(), g_boxes[:, s], rtol=1e-5,
                                   atol=1e-6)
    assert np.abs(g_boxes[:, 2:]).max() == 0 and np.abs(g_boxes[:, :2]).max() > 0
    # The box term: rank 0's pairs over the global count of scenes with pairs,
    # times the world size; so the group's mean loss is the one-process loss.
    from unidet3d_tpu_torch.losses import criterion as tcrit

    def t(x):
        return torch.from_numpy(x)

    one = tcrit.criterion(t(prob["logits"]), t(prob["boxes"]), t(prob["query_valid"]),
                          tcrit.SceneGT(t(prob["labels"]), t(prob["gt_boxes"]),
                                        t(prob["gt_valid"]), t(prob["query_masks"])),
                          t(flags["rotated"]), t(flags["topk"]), t(flags["weights"]))
    np.testing.assert_allclose(np.mean([float(m["loss"]) for m in ranks]), float(one),
                               rtol=1e-5)


# ------------------------------------------------------ (c) the whole step

def _step_inputs():
    """The train slice's small config and 4 scenes (ScanNet, MultiScan,
    ScanNet, MultiScan), and seeded weights; asserts that no voxel is
    dropped."""
    from tests.test_torch_train_slice import CAPS, _sample
    from unidet3d_tpu_torch.core.class_table import build_class_table
    from unidet3d_tpu_torch.core.config import DATASETS_CLASSES, default_config
    from unidet3d_tpu_torch.data.batcher import collate
    from unidet3d_tpu_torch.models.detector import UniDet3D
    from unidet3d_tpu_torch.weights import seeded_init_

    # Four times the slice's voxel capacity, so that no level overflows: which
    # voxels an overflow drops depends on the scenes that share a batch, so
    # with drops 2 x 2 scenes and 4 scenes are different inputs.
    cfg = default_config(**dict(CAPS, voxel_capacity=8192))
    samples = [_sample(0, 0, 18), _sample(1, 2, 17), _sample(2, 0, 18), _sample(3, 2, 17)]
    net = seeded_init_(UniDet3D(cfg, build_class_table(DATASETS_CLASSES), device="cpu"), 0)
    for i in range(len(samples)):
        _, _, pack = collate(samples[i:i + 1], cfg)
        assert all(n < c for n, c in zip(pack.n_valid, cfg.level_capacities(1))), pack.n_valid
    return cfg, samples, net.state_dict()


def _train_step(rank, world, cfg, samples, init):
    """One make_train_step on this rank's share of `samples` (all of them in
    one process), queries drawn from a generator seeded 7. Rank 0 loads
    `init`, the others zeros, then broadcast_module."""
    from unidet3d_tpu_torch.core.class_table import build_class_table
    from unidet3d_tpu_torch.core.config import DATASETS_CLASSES
    from unidet3d_tpu_torch.data.batcher import collate, gt_to_device, to_device
    from unidet3d_tpu_torch.models.detector import UniDet3D
    from unidet3d_tpu_torch.parallel.train_step import make_train_step
    from unidet3d_tpu_torch.train.optim import make_optimizer

    n = len(samples) // world
    batch, gt, pack = collate(samples[rank * n:(rank + 1) * n], cfg,
                              rng=np.random.RandomState(0))
    net = UniDet3D(cfg, build_class_table(DATASETS_CLASSES), device="cpu")
    net.load_state_dict(init if rank == 0 else {k: torch.zeros_like(v)
                                                for k, v in init.items()})
    pdist.broadcast_module(net)
    opt = make_optimizer(net.parameters())
    step = make_train_step(net, cfg, opt)
    tb, tp = to_device(batch, pack, "cpu")
    metrics = step(tb, gt_to_device(gt, "cpu"), tp, torch.Generator().manual_seed(7),
                   host_dataset_ids=batch.dataset_ids)
    return dict(loss=metrics["loss"], grad_norm=metrics["grad_norm"],
                grads={k: p.grad.clone() for k, p in net.named_parameters()},
                state={k: v.clone() for k, v in net.state_dict().items()})


def test_two_ranks_take_the_one_process_step(tmp_path):
    torch.set_num_threads(1)
    cfg, samples, init = _step_inputs()
    ranks = run_ranks(tmp_path, _train_step, cfg, samples, init)
    one = _train_step(0, 1, cfg, samples, init)
    # The group's loss and gradient norm, every rank alike.
    for r in ranks:
        assert torch.equal(r["loss"], ranks[0]["loss"])
        assert torch.equal(r["grad_norm"], ranks[0]["grad_norm"])
    # fp32; the batch norms' and the backward's sums run in another order
    # (per rank, then over the group).
    np.testing.assert_allclose(float(ranks[0]["loss"]), float(one["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(ranks[0]["grad_norm"]), float(one["grad_norm"]),
                               rtol=1e-4)
    assert ranks[0]["grads"].keys() == one["grads"].keys()
    for name, ref in one["grads"].items():
        err = (ranks[0]["grads"][name] - ref).abs().max().item()
        assert err <= 1e-5 * ref.abs().max().item() + 1e-8, (name, err)
    stats = [k for k in one["state"] if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * 25  # the small config's 25 batch norms
    for name in stats:
        torch.testing.assert_close(ranks[0]["state"][name], one["state"][name], rtol=1e-5,
                                   atol=1e-6, msg=name)
    # After the step the ranks hold the same parameters and statistics, bit
    # for bit.
    for name, value in ranks[0]["state"].items():
        assert torch.equal(value, ranks[1]["state"][name]), name


# ------------------------------------------------------------- (d) train()

class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.stats = []

    def emit(self, record):
        if hasattr(record, "train_stats"):
            self.stats.append(record.train_stats)


def _train_rank(rank, world, exp, resume_exp):
    """train(exp) then train(resume_exp, resume="auto") in this rank, with
    the loop's log records, the batches its loader gave (dataset ids and
    points of each) and what each validation returned."""
    from unidet3d_tpu_torch.train import loop

    batches = []

    class Recording(loop.TrainLoader):
        def __next__(self):
            tb = super().__next__()
            batches.append((tb.host[0].dataset_ids.copy(), tb.host[0].points.copy()))
            return tb

    loop.TrainLoader = Recording
    results = []
    evaluate = loop.evaluate

    def recording_evaluate(*args, **kw):
        results.append(evaluate(*args, **kw))
        return results[-1]

    loop.evaluate = recording_evaluate
    logger = logging.getLogger("unidet3d_tpu_torch")
    logger.setLevel(logging.INFO)
    out = {}
    for tag, e, resume in (("first", exp, None), ("resumed", resume_exp, "auto")):
        rec = _Records()
        logger.addHandler(rec)
        try:
            net, opt = loop.train(e, resume=resume, device="cpu")
        finally:
            logger.removeHandler(rec)
        out[tag] = dict(stats=rec.stats, state=net.state_dict(), count=opt.count,
                        ckpts=sorted(os.listdir(os.path.join(e.work_dir, "checkpoints"))))
    out["batches"] = batches
    out["val"] = results
    return out


def test_train_in_two_ranks(tmp_path):
    import dataclasses

    from tests.test_torch_train_loop import ARKIT, MULTISCAN, experiment, scene
    from unidet3d_tpu_torch.data.datasets import ConcatDataset
    from unidet3d_tpu_torch.data.synthetic import write_info_dataset
    from unidet3d_tpu_torch.train import loop
    from unidet3d_tpu_torch.train.checkpoint import CheckpointManager

    torch.set_num_threads(1)
    names = {MULTISCAN: "multiscan", ARKIT: "arkitscenes"}
    roots = {}
    for ds, sizes in ((MULTISCAN, ((1500, 1800, 1700), (1400, 1900))),
                      (ARKIT, ((1700, 1600), (1600, 1500)))):
        roots[ds] = str(tmp_path / names[ds])
        for split, pts in zip(("train", "val"), sizes):
            write_info_dataset(roots[ds], [scene(ds, f"{split}{i}", n, 100 * ds + 10 * i)
                                           for i, n in enumerate(pts)],
                               ann_file=f"infos_{split}.pkl")
    exp = experiment(roots, tmp_path / "work", batch_size=4, epochs=1, ckpt_max_keep=2)
    ranks = run_ranks(tmp_path, _train_rank, exp, dataclasses.replace(exp, epochs=2))
    first = [r["first"] for r in ranks]

    # One checkpoint, written by rank 0 only; equal models across ranks.
    assert first[0]["ckpts"] == first[1]["ckpts"] == ["2.pth"]
    assert [st["step"] for st in first[0]["stats"] if st["kind"] == "checkpoint"] == [2]
    assert not [st for st in first[1]["stats"] if st["kind"] in ("checkpoint", "interval")]
    for tag in ("first", "resumed"):
        a, b = ranks[0][tag]["state"], ranks[1][tag]["state"]
        assert all(torch.equal(a[k], b[k]) for k in a), tag
    # The checkpoint holds the model train() returned.
    net, _ = loop.build_model(exp, device="cpu")
    assert CheckpointManager(os.path.join(exp.work_dir, "checkpoints")).restore(net, step=2) == 2
    assert all(torch.equal(v, first[0]["state"][k]) for k, v in net.state_dict().items())

    # --resume auto restores step 2 on both ranks and trains epoch 2 only.
    for r in ranks:
        assert [st for st in r["resumed"]["stats"] if st["kind"] == "resume"] == [
            dict(kind="resume", step=2)]
        assert r["resumed"]["count"] == 4 and r["resumed"]["ckpts"] == ["2.pth", "4.pth"]

    # The gathered validation: every rank's results equal a one-process
    # evaluate of the checkpoint's model, key by key.
    # (Validation after epochs 1 and 2: the first run's, then the resumed one's.)
    assert len(ranks[0]["val"]) == 2 and ranks[0]["val"] == ranks[1]["val"]
    assert [st["results"] for st in first[0]["stats"] if st["kind"] == "val"] == [
        ranks[0]["val"][0]]
    ref = loop.evaluate(exp, net, device="cpu", logger=None)
    got = ranks[0]["val"][0]
    assert got.keys() == ref.keys() and all(got[n].keys() == ref[n].keys() for n in ref)
    for n in ref:
        for k in ref[n]:
            np.testing.assert_allclose(got[n][k], ref[n][k], rtol=1e-6, atol=1e-9,
                                       err_msg=(n, k))

    # Rank r's batches: a one-process TrainLoader of the local batch from
    # seed + 7919 r, from batch 1 (both runs restart the loader there).
    concat = ConcatDataset(loop.build_datasets(exp, "train"))
    for r, res in enumerate(ranks):
        ref_loader = loop.TrainLoader(concat, exp.model, 2, seed=exp.seed + 7919 * r,
                                      device="cpu", start=1)
        try:
            want = [next(ref_loader).host[0] for _ in range(2)]
        finally:
            ref_loader.close()
        assert len(res["batches"]) == 4  # 2 steps, then 2 after the resume
        for (ids, pts), hb in zip(res["batches"], want + want):
            np.testing.assert_array_equal(ids, hb.dataset_ids)
            np.testing.assert_array_equal(pts, hb.points)
    assert not np.array_equal(ranks[0]["batches"][0][1], ranks[1]["batches"][0][1])


# ------------------------------------------------------ maybe_initialize

@pytest.mark.parametrize("local_world, cards, nccl, backend", [
    (1, 0, True, "gloo"),  # the CPU
    (2, 1, True, "gloo"),  # two ranks share one card
    (4, 4, True, "nccl"),  # a card per rank
    (2, 8, True, "nccl"),
    (2, 2, False, "gloo"),  # no NCCL in this build
])
def test_backend_choice(monkeypatch, local_world, cards, nccl, backend):
    monkeypatch.setattr(dist, "is_nccl_available", lambda: nccl)
    assert pdist.choose_backend(local_world, cards) == backend


def test_maybe_initialize_is_a_no_op_in_one_process(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert pdist.maybe_initialize() is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert pdist.maybe_initialize() is False
    assert pdist.rank_world() == (0, 1) and pdist.local_batch_size(8) == 8


def test_maybe_initialize_raises_when_the_group_cannot_form(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(RuntimeError, match="RANK is not set"):
        pdist.maybe_initialize()
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", "1")

    def refuse(*args, **kw):
        raise RuntimeError("connection refused")

    monkeypatch.setattr(dist, "init_process_group", refuse)
    with pytest.raises(RuntimeError, match="connection refused"):
        pdist.maybe_initialize()
    assert not dist.is_initialized()
