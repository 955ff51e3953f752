"""The port's training loop (``unidet3d_tpu_torch/train/loop.py::train``) and
CLIs (``tools/train.py``, ``tools/test.py``) on the CPU, on tiny on-disk
datasets (``data/synthetic.py::write_info_dataset``: MultiScan and
ARKitScenes scenes, narrow widths, fp32):

  * ``_val_epochs`` equals the JAX function over a grid;
  * ``train`` for 2 epochs x 2 steps, with validation after each epoch,
    equals bit for bit the same steps taken by hand with ``make_train_step``
    on ``TrainLoader`` batches 1..4 from the same ``seeded_init_`` and a
    generator seeded with seed + 1 (the step that
    ``test_torch_train_slice.py`` holds against the JAX step); its
    checkpoints at steps 2 and 4 hold those states;
  * collate's drops raise the interval's warning;
  * ``resume="auto"`` starts at epoch 2 with optimizer count 2, and, as in
    the JAX loop, restarts the loader at batch 1 and the generator at seed + 1;
  * ``load_from`` with prefix ``backbone`` (a converted reference
    checkpoint) changes only ``backbone.*`` and raises when nothing matches;
  * the CLIs run through ``main([..., "--device", "cpu"])`` and the test CLI
    prints the mAP of ``evaluate`` on the restored model.
PyTorch runs on one intra-op thread here, so that the CPU's sums keep one
order.
"""
import dataclasses
import logging
import os
import shutil

import numpy as np
import pytest
import torch

from tests.test_torch_checkpoint import assert_states_equal
from unidet3d_tpu.core.config import default_config as jax_config
from unidet3d_tpu.core.experiment import ExperimentConfig as JaxExperiment
from unidet3d_tpu.train.loop import _val_epochs as jax_val_epochs
from unidet3d_tpu_torch.core.config import DATASETS_CLASSES, default_config
from unidet3d_tpu_torch.core.experiment import DatasetSpec, ExperimentConfig, load_experiment
from unidet3d_tpu_torch.data.dataset_specs import DEFAULT_LABEL_MAPPINGS
from unidet3d_tpu_torch.data.datasets import ConcatDataset
from unidet3d_tpu_torch.data.loader import TrainLoader
from unidet3d_tpu_torch.data.synthetic import (
    reference_state_dict,
    stripe_superpoints,
    synthetic_scene,
    write_info_dataset,
)
from unidet3d_tpu_torch.parallel.train_step import make_train_step
from unidet3d_tpu_torch.tools import convert_checkpoint
from unidet3d_tpu_torch.tools import test as test_cli
from unidet3d_tpu_torch.tools import train as train_cli
from unidet3d_tpu_torch.train import loop
from unidet3d_tpu_torch.train.checkpoint import CheckpointManager, save_params
from unidet3d_tpu_torch.train.optim import make_optimizer
from unidet3d_tpu_torch.weights import seeded_init_

TINY = dict(max_points=2048, voxel_capacity=2048, max_superpoints=128, max_gts=16,
            query_thr=48, num_planes=(8, 16, 24), d_model=32, num_heads=2, hidden_dim=128,
            num_layers=1, topk_insts=32, compute_dtype="float32")
MULTISCAN, ARKIT = 2, 5
# Points per scene; scenes above max_points make collate subsample (a drop).
TRAIN_POINTS = {MULTISCAN: (1500, 2600, 1800), ARKIT: (1700, 2200)}
VAL_POINTS = {MULTISCAN: (1400, 1900), ARKIT: (1600,)}
N_INST = 6
STRIPE = 20


def scene(ds, name, n, seed):
    """Instances are runs of 5 stripe superpoints with their points' bounds
    as boxes; MultiScan's labels are its raw ids, ARKitScenes' boxes carry a
    yaw and its colors lie in [0, 1]."""
    rng = np.random.RandomState(seed)
    pts = synthetic_scene(n, seed=seed)
    sp = stripe_superpoints(pts, STRIPE)
    inst = np.where(sp < 5 * N_INST, sp // 5, -1)
    lo = np.stack([pts[inst == k, :3].min(0) for k in range(N_INST)])
    hi = np.stack([pts[inst == k, :3].max(0) for k in range(N_INST)])
    boxes = np.concatenate([(lo + hi) / 2, hi - lo], 1).astype(np.float32)
    labels = rng.randint(0, len(DATASETS_CLASSES[ds]), N_INST)
    raw = pts.copy()
    raw[:, 3:] = (pts[:, 3:] + 1) * (0.5 if ds == ARKIT else 127.5)
    out = dict(name=name, points=raw, super_points=sp, instance_mask=inst)
    if ds == MULTISCAN:
        raw_id = {i: c for c, i in DEFAULT_LABEL_MAPPINGS["multiscan"].items()}
        out.update(boxes=boxes, labels=np.asarray([raw_id[i] for i in labels]))
    else:
        yaw = rng.uniform(-np.pi, np.pi, (N_INST, 1)).astype(np.float32)
        out.update(boxes=np.concatenate([boxes, yaw], 1), labels=labels)
    return out


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("train_loop")
    out = {}
    for ds in (MULTISCAN, ARKIT):
        out[ds] = str(base / default_config().datasets[ds])
        for split, sizes in (("train", TRAIN_POINTS[ds]), ("val", VAL_POINTS[ds])):
            write_info_dataset(out[ds], [scene(ds, f"{split}{i}", n, 100 * ds + 10 * i + len(split))
                                         for i, n in enumerate(sizes)],
                               ann_file=f"infos_{split}.pkl")
    return out


def experiment(roots, work_dir, **kw):
    names = default_config().datasets
    base = dict(model=default_config(**TINY), batch_size=2, epochs=2, steps_per_epoch=2,
                log_interval=1, ckpt_interval_epochs=1, ckpt_max_keep=2,
                val_interval_epochs=1, val_last_epochs=0, eval_batch_size=2, seed=3,
                work_dir=str(work_dir),
                datasets=tuple(DatasetSpec(names[ds], root, ann_train="infos_train.pkl",
                                           ann_val="infos_val.pkl")
                               for ds, root in roots.items()))
    base.update(kw)
    return ExperimentConfig(**base)


class Records(logging.Handler):
    """Collects the loop's log records."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.records = []

    def emit(self, record):
        self.records.append(record)

    def stats(self, kind):
        return [r.train_stats for r in self.records
                if getattr(r, "train_stats", {}).get("kind") == kind]


def recorded(fn, *args, **kw):
    """fn(*args, **kw) with the port's logger recorded: (result, Records)."""
    logger = logging.getLogger("unidet3d_tpu_torch")
    handler, level = Records(), logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        return fn(*args, **kw), handler
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)


def by_hand(exp, batches, start=None):
    """The steps of `exp` taken by hand: the model from seeded_init_ (or the
    checkpoint `start`), make_train_step on TrainLoader batches `batches`
    (indices), a generator seeded with seed + 1. Returns the model, the
    optimizer and their states after each step."""
    net, _ = loop.build_model(exp, device="cpu")
    seeded_init_(net, exp.seed)
    opt = make_optimizer(net.parameters(), base_lr=exp.lr, weight_decay=exp.weight_decay,
                         total_steps=exp.total_steps, power=exp.lr_power,
                         clip_norm=exp.clip_norm)
    if start is not None:
        assert CheckpointManager(start[0]).restore(net, opt, start[1]) == start[1]
    step = make_train_step(net, exp.model, opt)
    gen = torch.Generator().manual_seed(exp.seed + 1)
    loader = TrainLoader(ConcatDataset(loop.build_datasets(exp, "train")), exp.model,
                         exp.batch_size, seed=exp.seed, device="cpu", start=batches[0])
    states = []
    try:
        for _ in batches:
            tb = next(loader)
            step(tb.batch, tb.gt, tb.pack, gen, host_dataset_ids=tb.host[0].dataset_ids)
            states.append((clone(net.state_dict()), clone(opt.state_dict())))
    finally:
        loader.close()
    return net, opt, states


def clone(state):
    if isinstance(state, torch.Tensor):
        return state.clone()
    if isinstance(state, dict):
        return {k: clone(v) for k, v in state.items()}
    if isinstance(state, list):
        return [clone(v) for v in state]
    return state


@pytest.mark.parametrize("epochs, interval, last", [
    (1024, 16, 16), (2, 1, 0), (5, 2, 1), (17, 16, 16), (3, 100, 0), (40, 16, 3)])
def test_val_epochs_match_jax(epochs, interval, last):
    mine = dataclasses.replace(experiment({}, "w"), epochs=epochs, val_interval_epochs=interval,
                               val_last_epochs=last)
    ref = JaxExperiment(model=jax_config(), datasets=(), epochs=epochs,
                        val_interval_epochs=interval, val_last_epochs=last)
    assert loop._val_epochs(mine) == jax_val_epochs(ref)


@pytest.fixture(scope="module")
def trained(roots, tmp_path_factory):
    exp = experiment(roots, tmp_path_factory.mktemp("work"))
    (net, opt), rec = recorded(loop.train, exp, device="cpu")
    _, _, states = by_hand(exp, [1, 2, 3, 4])
    return dict(exp=exp, net=net, opt=opt, rec=rec, states=states)


def test_train_equals_the_steps_taken_by_hand(trained):
    want_model, want_opt = trained["states"][-1]
    assert_states_equal(trained["net"].state_dict(), want_model)
    assert_states_equal(trained["opt"].state_dict(), want_opt)
    assert trained["opt"].count == 4
    intervals = trained["rec"].stats("interval")
    assert [(s["epoch"], s["it"], s["step"]) for s in intervals] == [
        (1, 1, 1), (1, 2, 2), (2, 1, 3), (2, 2, 4)]
    assert all(np.isfinite(s["loss"]) for s in intervals)
    exp = trained["exp"]
    lrs = [exp.lr * (1 - t / 4) ** exp.lr_power for t in range(4)]
    assert [s["lr"] for s in intervals] == pytest.approx(lrs, rel=1e-12)
    vals = trained["rec"].stats("val")
    assert [v["epoch"] for v in vals] == [1, 2]  # validation between the epochs changed nothing
    assert set(vals[0]["results"]) == {"multiscan", "arkitscenes"}


def test_checkpoints_hold_the_steps_and_are_kept(trained):
    exp = trained["exp"]
    mngr = CheckpointManager(os.path.join(exp.work_dir, "checkpoints"), exp.ckpt_max_keep)
    assert mngr.all_steps() == [2, 4]
    assert [c["step"] for c in trained["rec"].stats("checkpoint")] == [2, 4]
    for step in (2, 4):
        ckpt = torch.load(mngr.path(step), weights_only=True)
        model, opt = trained["states"][step - 1]
        assert_states_equal(ckpt["model"], model)
        assert_states_equal(ckpt["optimizer"], opt)
        assert ckpt["step"] == step


def test_collate_drops_raise_the_interval_warning(trained):
    # Scenes of 2,200-2,600 points exceed max_points 2,048.
    warnings = [r for r in trained["rec"].records if r.levelno == logging.WARNING]
    assert warnings and all("capacity drops this interval" in r.getMessage()
                            for r in warnings)
    assert any("points_dropped=" in r.getMessage() for r in warnings)
    drops = trained["rec"].stats("drops")
    assert len(drops) == len(warnings) and any(d.get("points_dropped", 0) > 0 for d in drops)


def test_resume_auto_starts_at_epoch_two_with_count_two(trained, roots, tmp_path):
    exp = dataclasses.replace(trained["exp"], work_dir=str(tmp_path), val_interval_epochs=100)
    os.makedirs(tmp_path / "checkpoints")
    src = CheckpointManager(os.path.join(trained["exp"].work_dir, "checkpoints"))
    shutil.copy(src.path(2), tmp_path / "checkpoints" / "2.pth")
    (net, opt), rec = recorded(loop.train, exp, resume="auto", device="cpu")
    assert rec.stats("resume") == [dict(kind="resume", step=2)]
    assert [(s["epoch"], s["step"]) for s in rec.stats("interval")] == [(2, 3), (2, 4)]
    assert opt.count == 4
    # Inherited from the JAX loop: the loader restarts at batch 1 and the
    # generator at seed + 1 on resume.
    _, _, states = by_hand(exp, [1, 2], start=(str(tmp_path / "checkpoints"), 2))
    assert_states_equal(net.state_dict(), states[-1][0])
    assert_states_equal(opt.state_dict(), states[-1][1])
    with pytest.raises(FileNotFoundError, match="no checkpoint of step 3"):
        loop.train(exp, resume="3", device="cpu")


def test_load_from_changes_only_the_backbone(roots, tmp_path):
    exp = experiment(roots, tmp_path / "work", epochs=0)
    cfg = exp.model
    sd = reference_state_dict(cfg.num_planes, cfg.d_model, cfg.num_layers, 100, seed=5)
    donor = convert_checkpoint.convert_state_dict(
        sd, num_levels=len(cfg.num_planes), num_layers=cfg.num_layers, d_model=cfg.d_model)
    save_params(str(tmp_path / "converted.pth"), donor)
    init, _ = loop.build_model(exp, device="cpu")
    init = seeded_init_(init, exp.seed).state_dict()
    net, _ = loop.train(dataclasses.replace(exp, load_from=str(tmp_path / "converted.pth")),
                        device="cpu")
    got = net.state_dict()
    assert any(k.endswith("running_var") and k.startswith("backbone.") for k in got)
    for k, v in got.items():
        want = donor[k] if k.startswith("backbone.") else init[k]
        assert torch.equal(v, want), k
    with pytest.raises(ValueError, match="no tensor under 'head'"):
        loop.train(dataclasses.replace(exp, load_from=str(tmp_path / "converted.pth"),
                                       load_prefix="head"), device="cpu")


def test_train_runs_in_one_process_only(roots, tmp_path, monkeypatch):
    """Without a process group train() runs in one process only: launched as
    one of several ranks (WORLD_SIZE > 1) before the group is joined, it
    raises instead of training alone."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="maybe_initialize"):
        loop.train(experiment(roots, tmp_path), device="cpu")


CONFIG = """
from unidet3d_tpu_torch.core.config import default_config
from unidet3d_tpu_torch.core.experiment import DatasetSpec, ExperimentConfig, load_experiment


def get_config():
    return ExperimentConfig(
        model=default_config(**{tiny!r}), batch_size=2, epochs=1, steps_per_epoch=2,
        log_interval=1, val_interval_epochs=100, val_last_epochs=0, eval_batch_size=2,
        seed=3, work_dir={work!r},
        datasets=(DatasetSpec("multiscan", {root!r}, ann_train="infos_train.pkl",
                              ann_val="infos_val.pkl"),))
"""


def test_cli_train_then_test_prints_the_evaluate_map(roots, tmp_path, capsys):
    cfg = tmp_path / "tiny.py"
    cfg.write_text(CONFIG.format(tiny=TINY, work=str(tmp_path / "unused"),
                                 root=roots[MULTISCAN]))
    work = tmp_path / "work"
    net, opt = train_cli.main([str(cfg), "--work-dir", str(work), "--device", "cpu",
                               "--cfg-options", "lr=1e-3"])
    assert opt.count == 2 and opt.adamw.param_groups[0]["lr"] == 1e-3 * (1 - 1 / 2) ** 0.9
    assert CheckpointManager(str(work / "checkpoints")).all_steps() == [2]
    capsys.readouterr()
    results = test_cli.main([str(cfg), str(work / "checkpoints"), "--device", "cpu"])
    printed = capsys.readouterr().out
    exp = load_experiment(str(cfg))
    restored, _ = loop.build_model(exp, device="cpu")
    CheckpointManager(str(work / "checkpoints")).restore(restored)
    assert_states_equal(restored.state_dict(), net.state_dict())
    want = loop.evaluate(exp, restored, device="cpu", logger=lambda *a: None)
    assert results == want
    res = want["multiscan"]
    assert (f"multiscan: mAP@0.25={res['mAP_0.25']:.4f} mAP@0.50={res['mAP_0.50']:.4f}"
            in printed.splitlines())
    # --show-dir: the same results, and one directory per val scene, named by
    # its index in the info file.
    shown = test_cli.main([str(cfg), str(work / "checkpoints"), "--device", "cpu",
                           "--show-dir", str(tmp_path / "show")])
    assert shown == want
    assert sorted(os.listdir(tmp_path / "show")) == [
        f"multiscan_scene{k:05d}" for k in range(len(VAL_POINTS[MULTISCAN]))]
    with pytest.raises(FileNotFoundError, match="no checkpoint found"):
        test_cli.main([str(cfg), str(tmp_path / "none"), "--device", "cpu"])


def test_clis_need_the_card_unless_cpu_is_asked(roots, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    cfg = tmp_path / "tiny.py"
    cfg.write_text(CONFIG.format(tiny=TINY, work=str(tmp_path / "work"),
                                 root=roots[MULTISCAN]))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main([str(cfg)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        test_cli.main([str(cfg), str(tmp_path)])
    assert not os.path.exists(tmp_path / "work")


def test_cli_flags_reach_the_experiment(roots, tmp_path):
    cfg = tmp_path / "tiny.py"
    cfg.write_text(CONFIG.format(tiny=TINY, work=str(tmp_path / "unused"),
                                 root=roots[MULTISCAN]))
    net, opt = train_cli.main([str(cfg), "--work-dir", str(tmp_path / "w"), "--device", "cpu",
                               "--precision", "bf16", "--auto-scale-lr",
                               "--cfg-options", "epochs=0", "lr=4e-4"])
    assert net.cfg.compute_dtype == "bfloat16" and TINY["compute_dtype"] == "float32"
    assert opt.schedule(0) == 4e-4 * 2 / 8  # batch 2 over base_batch_size 8
    assert os.path.isdir(tmp_path / "w") and not os.path.exists(tmp_path / "unused")
