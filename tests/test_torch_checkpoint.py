"""The port's checkpoints (``unidet3d_tpu_torch/train/checkpoint.py``) and the
optimizer's state (``ClippedAdamW.state_dict``) against the JAX package's
orbax ``CheckpointManager``, ``merge_by_prefix`` and optax schedule: a
bit-equal round trip of model and optimizer that resumes the schedule where
it was, the same kept steps under one sequence of saves, ``latest_step``
past a temporary file, ``merge_by_prefix`` equal to the JAX one on a
parameters-only donor (through ``weights.from_flax``) and taking the
prefix's running statistics besides, and the JAX ``load_from`` no-op on the
converter's whole tree that the port does not copy."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from unidet3d_tpu.tools.convert_checkpoint import convert_torch_state_dict
from unidet3d_tpu.train import checkpoint as jax_checkpoint
from unidet3d_tpu.train.optim import poly_schedule as jax_poly_schedule
from unidet3d_tpu_torch.core.class_table import build_class_table
from unidet3d_tpu_torch.core.config import DATASETS_CLASSES, default_config
from unidet3d_tpu_torch.data.synthetic import reference_state_dict
from unidet3d_tpu_torch.models.detector import UniDet3D
from unidet3d_tpu_torch.train import checkpoint
from unidet3d_tpu_torch.train.optim import make_optimizer
from unidet3d_tpu_torch.weights import from_flax, seeded_init_

WIDTHS = dict(num_planes=(8, 16, 24), d_model=32, num_heads=2, hidden_dim=128, num_layers=2)
N_CLS = 100  # the unified class table's classes + 1 (no object)
OPT = dict(base_lr=2e-4, weight_decay=0.05, total_steps=10, power=0.9, clip_norm=10.0)


def small_model(seed=0):
    net = UniDet3D(default_config(**WIDTHS), build_class_table(DATASETS_CLASSES), device="cpu")
    return seeded_init_(net, seed)


def fake_step(net, opt, seed):
    """One optimizer step on gradients drawn from `seed` (no forward)."""
    gen = torch.Generator().manual_seed(seed)
    for p in net.parameters():
        p.grad = torch.randn(p.shape, generator=gen)
    opt.step()


def assert_states_equal(a, b, where=""):
    """Nested dicts / lists of tensors and numbers equal bit for bit."""
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype, where
        assert torch.equal(a, b), where
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            assert_states_equal(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_states_equal(x, y, f"{where}[{i}]")
    else:
        assert a == b, (where, a, b)


def test_round_trip_is_bit_equal_and_resumes_the_schedule(tmp_path):
    net = small_model()
    opt = make_optimizer(net.parameters(), **OPT)
    for s in range(3):
        fake_step(net, opt, s)
    mngr = checkpoint.CheckpointManager(str(tmp_path / "ckpt"))
    path = mngr.save(3, net, opt)
    assert os.path.basename(path) == "3.pth" and mngr.latest_step() == 3

    net2 = UniDet3D(net.cfg, build_class_table(DATASETS_CLASSES), device="cpu")  # zeros
    opt2 = make_optimizer(net2.parameters(), **OPT)
    assert mngr.restore(net2, opt2) == 3
    assert_states_equal(net2.state_dict(), net.state_dict())
    assert_states_equal(opt2.state_dict(), opt.state_dict())
    assert opt2.count == 3

    # The next step of both is the same, at the schedule's value at count 3.
    fake_step(net, opt, 3)
    fake_step(net2, opt2, 3)
    assert_states_equal(net2.state_dict(), net.state_dict())
    assert_states_equal(opt2.state_dict(), opt.state_dict())
    lr = opt2.adamw.param_groups[0]["lr"]
    assert lr == jax_poly_schedule(OPT["base_lr"], OPT["total_steps"], OPT["power"])(3)
    optax_lr = optax.polynomial_schedule(OPT["base_lr"], 0.0, OPT["power"],
                                         OPT["total_steps"])(3)
    assert lr == pytest.approx(float(optax_lr), rel=1e-6)


def test_restore_names_the_model_device_and_is_strict(tmp_path):
    net = small_model()
    opt = make_optimizer(net.parameters(), **OPT)
    fake_step(net, opt, 0)
    mngr = checkpoint.CheckpointManager(str(tmp_path))
    mngr.save(1, net, opt)
    other = UniDet3D(default_config(**dict(WIDTHS, num_layers=1)),
                     build_class_table(DATASETS_CLASSES), device="cpu")
    with pytest.raises(RuntimeError, match="state_dict"):
        mngr.restore(other)
    with pytest.raises(FileNotFoundError, match="no checkpoint of step 7"):
        mngr.restore(net, step=7)
    assert checkpoint.CheckpointManager(str(tmp_path / "empty")).restore(net) is None
    assert not os.path.exists(tmp_path / "empty")


@pytest.mark.parametrize("max_to_keep, steps", [
    (1, (2, 4, 6)),
    (2, (2, 4, 6, 8, 10)),
    (3, (1, 2, 5, 9, 10, 30)),
    (16, (4, 8, 12)),
])
def test_kept_steps_match_orbax(tmp_path, max_to_keep, steps):
    ref = jax_checkpoint.CheckpointManager(str(tmp_path / "jax"), max_to_keep)
    mngr = checkpoint.CheckpointManager(str(tmp_path / "port"), max_to_keep)
    net = small_model()
    opt = make_optimizer(net.parameters(), **OPT)
    try:
        for step in steps:
            ref.save(step, {"w": jnp.zeros(2)})
            mngr.save(step, net, opt)
            assert mngr.all_steps() == sorted(ref._mngr.all_steps())
            assert mngr.latest_step() == ref.latest_step()
    finally:
        ref.close()


def test_latest_step_ignores_temporary_and_cut_saves(tmp_path, monkeypatch):
    net = small_model()
    opt = make_optimizer(net.parameters(), **OPT)
    mngr = checkpoint.CheckpointManager(str(tmp_path))
    mngr.save(4, net, opt)
    (tmp_path / "6.pth.tmp-123").write_bytes(b"half a file")
    (tmp_path / "notes.txt").write_text("x")
    assert mngr.latest_step() == 4 and mngr.all_steps() == [4]

    def cut(obj, path):
        with open(path, "wb") as f:
            f.write(b"half")
        raise KeyboardInterrupt

    monkeypatch.setattr(torch, "save", cut)
    with pytest.raises(KeyboardInterrupt):
        mngr.save(8, net, opt)
    assert not any(n.startswith("8.pth") for n in os.listdir(tmp_path))
    assert mngr.latest_step() == 4


def test_save_and_restore_params_round_trip(tmp_path):
    sd = small_model(3).state_dict()
    checkpoint.save_params(str(tmp_path / "sub" / "p.pth"), sd)
    assert_states_equal(checkpoint.restore_params(str(tmp_path / "sub" / "p.pth")), sd)


def converted(seed):
    """The JAX converter's {"params", "batch_stats"} tree of a synthetic
    reference checkpoint at the small widths."""
    sd = reference_state_dict(WIDTHS["num_planes"], WIDTHS["d_model"], WIDTHS["num_layers"],
                              N_CLS, seed=seed)
    return convert_torch_state_dict(sd, num_levels=3, num_layers=WIDTHS["num_layers"],
                                    d_model=WIDTHS["d_model"], num_heads=WIDTHS["num_heads"])


@pytest.fixture(scope="module")
def trees():
    return converted(0), converted(1)


@pytest.mark.parametrize("prefix", ["backbone", "decoder", ""])
def test_merge_by_prefix_matches_jax_on_a_params_donor(trees, prefix):
    target, donor = trees
    ref = jax_checkpoint.merge_by_prefix(target["params"], donor["params"], prefix)
    want = from_flax({"params": ref, "batch_stats": target["batch_stats"]})
    got = checkpoint.merge_by_prefix(from_flax(target), from_flax({"params": donor["params"]}),
                                     prefix)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_merge_by_prefix_takes_running_statistics(trees):
    target, donor = trees
    mine, theirs = from_flax(target), from_flax(donor)
    got = checkpoint.merge_by_prefix(mine, theirs, "backbone")
    stats = [k for k in got if k.endswith(("running_mean", "running_var"))]
    assert stats and all(k.startswith("backbone.") for k in stats)
    for k in got:
        src = theirs if k.startswith("backbone.") else mine
        assert torch.equal(got[k], src[k]), k
    net = UniDet3D(default_config(**WIDTHS), build_class_table(DATASETS_CLASSES), device="cpu")
    net.load_state_dict(got)  # strict


def test_merge_by_prefix_raises_when_nothing_or_something_wrong_matches(trees):
    target, donor = trees
    mine, theirs = from_flax(target), from_flax(donor)
    decoder_only = {k: v for k, v in theirs.items() if k.startswith("decoder.")}
    with pytest.raises(ValueError, match="no tensor under 'backbone'"):
        checkpoint.merge_by_prefix(mine, decoder_only, "backbone")
    with pytest.raises(ValueError, match="no tensor under 'backbon'"):
        checkpoint.merge_by_prefix(mine, theirs, "backbon")  # a name prefix, not a module
    bad = dict(theirs, **{"backbone.input_conv.weight": torch.zeros(27, 6, 4)})
    with pytest.raises(ValueError, match="shape mismatch"):
        checkpoint.merge_by_prefix(mine, bad, "backbone")
    extra = dict(theirs, **{"backbone.extra.weight": torch.zeros(1)})
    with pytest.raises(KeyError, match="backbone.extra.weight"):
        checkpoint.merge_by_prefix(mine, extra, "backbone")


def test_jax_load_from_takes_nothing_from_the_converted_tree(trees):
    """The fault of the reference package that the port does not copy: its
    loop hands the converter's whole {"params", "batch_stats"} tree to
    merge_by_prefix, which finds no "backbone" at the top and returns the
    parameters unchanged. The port's merge of the same checkpoint takes the
    backbone."""
    target, donor = trees
    merged = jax_checkpoint.merge_by_prefix(target["params"], donor, "backbone")
    same = jax.tree_util.tree_map(lambda a, b: bool(np.array_equal(a, b)), merged,
                                  target["params"])
    assert all(jax.tree_util.tree_leaves(same))
    got = checkpoint.merge_by_prefix(from_flax(target), from_flax(donor), "backbone")
    assert not torch.equal(got["backbone.input_conv.weight"],
                           from_flax(target)["backbone.input_conv.weight"])
