"""The port's activation recorder (``tools/record_activations.py``) against the
JAX package's:

  * its probe names are the committed fixture's
    (``tests/fixtures/activations_seed0.npz``, recorded by the JAX tool), and
    at the fixture's size (4,096 points, ``max_superpoints`` 512, the
    default config) so are the shapes and dtypes. The fixture's values are
    not compared here: the JAX test that does is ``slow``;
  * the probes equal the JAX ``record_activations`` run live on the same
    weights (the JAX init through ``weights.from_flax``) and the same inputs
    (each package's ``build_fixture_inputs``, compared first), at the full
    width in fp32 with the XLA conv on the JAX side, as
    ``test_torch_slice.py`` runs the forward. Tolerances are that file's:
    1e-4 (rtol and atol) for the backbone's features through 37 convs in
    another summation order, 1e-3 for the decoder's outputs on valid query
    rows (on padded rows the JAX XLA attention masks keys only), 1e-5 for the
    superpoint centers, the superpoint mask exact;
  * the CLI's ``--params``, ``--config`` and ``--points``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unidet3d_tpu_torch.tools import record_activations as rec_tool

FIXTURE = "tests/fixtures/activations_seed0.npz"
N_POINTS = 4096
S = 512
CAPS = dict(max_points=N_POINTS, voxel_capacity=N_POINTS, max_superpoints=S,
            compute_dtype="float32")


@pytest.fixture(scope="module")
def both():
    from unidet3d_tpu.core.config import default_config as jax_config
    from unidet3d_tpu.core.experiment import DatasetSpec, ExperimentConfig
    from unidet3d_tpu.tools.record_activations import build_fixture_inputs as jax_inputs
    from unidet3d_tpu.tools.record_activations import record_activations as jax_record
    from unidet3d_tpu.train.loop import build_model as jax_build_model

    from unidet3d_tpu_torch.core.class_table import build_class_table
    from unidet3d_tpu_torch.core.config import DATASETS_CLASSES, default_config
    from unidet3d_tpu_torch.data.batcher import to_device
    from unidet3d_tpu_torch.models.detector import UniDet3D
    from unidet3d_tpu_torch.weights import from_flax

    jexp = ExperimentConfig(model=jax_config(subm_impl="xla", **CAPS),
                            datasets=(DatasetSpec(name="scannet", data_root="."),))
    jmodel, _ = jax_build_model(jexp)
    jbatch_np, jpack_np = jax_inputs(jexp.model, seed=0, n_points=N_POINTS)
    jbatch = jax.tree_util.tree_map(jnp.asarray, jbatch_np)
    jpack = jax.tree_util.tree_map(jnp.asarray, jpack_np)
    rngs = {"params": jax.random.PRNGKey(0), "queries": jax.random.PRNGKey(1)}
    variables = jax.jit(lambda: jmodel.init(rngs, jbatch, False, jpack))()
    ref = jax_record(jmodel, variables, jbatch, jpack)

    cfg = default_config(**CAPS)
    batch, pack = rec_tool.build_fixture_inputs(cfg, seed=0, n_points=N_POINTS)
    net = UniDet3D(cfg, build_class_table(DATASETS_CLASSES), device="cpu")
    net.load_state_dict(from_flax(jax.device_get(variables)))
    net.train()  # the recorder runs the eval forward whatever the mode
    mine = rec_tool.record_activations(net, *to_device(batch, pack, "cpu"))
    assert net.training
    return dict(ref=ref, mine=mine, batch=batch, pack=pack, jbatch=jbatch_np,
                jpack=jpack_np)


def test_fixture_inputs_equal_the_jax_ones(both):
    for name in ("points", "vox_src", "features", "valid", "sp_ids", "dataset_ids"):
        np.testing.assert_array_equal(getattr(both["batch"], name),
                                      getattr(both["jbatch"], name), err_msg=name)
    for name in ("valid", "neighbors", "parent", "offset_code"):
        for mine, ref in zip(getattr(both["pack"], name), getattr(both["jpack"], name)):
            np.testing.assert_array_equal(mine, np.asarray(ref), err_msg=name)


def test_probe_names_are_the_fixtures_and_the_jax_recorders(both):
    names = set(np.load(FIXTURE).files)
    assert set(both["mine"]) == set(both["ref"]) == names


def test_backbone_probe_matches_jax(both):
    name = "inter/backbone/__call__/0"
    np.testing.assert_allclose(both["mine"][name], both["ref"][name], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["inter/decoder/__call__/0/0", "inter/decoder/__call__/0/1",
                                  "out/cls_logits", "out/boxes"])
def test_decoder_probes_match_jax_on_valid_queries(both, name):
    mine, ref = both["mine"][name], both["ref"][name]
    valid = both["ref"]["aux/sp_valid"]
    assert mine.shape == ref.shape and mine.dtype == ref.dtype
    assert valid.sum() > 0
    np.testing.assert_allclose(mine[:, valid], ref[:, valid], rtol=1e-3, atol=1e-3)


def test_superpoint_probes_match_jax(both):
    np.testing.assert_array_equal(both["mine"]["aux/sp_valid"], both["ref"]["aux/sp_valid"])
    np.testing.assert_allclose(both["mine"]["aux/sp_centers"], both["ref"]["aux/sp_centers"],
                               rtol=1e-5, atol=1e-5)


def test_cli_at_the_fixture_size_gives_its_shapes_and_dtypes(tmp_path):
    out = tmp_path / "rec.npz"
    rec = rec_tool.main([str(out), "--device", "cpu"])
    fx, saved = np.load(FIXTURE), np.load(out)
    assert set(saved.files) == set(rec) == set(fx.files)
    for name in fx.files:
        assert saved[name].shape == fx[name].shape, name
        assert saved[name].dtype == fx[name].dtype, name
        np.testing.assert_array_equal(saved[name], rec[name])
        assert np.isfinite(rec[name]).all(), name


CONFIG = """
from unidet3d_tpu_torch.core.config import default_config
from unidet3d_tpu_torch.core.experiment import DatasetSpec, ExperimentConfig


def get_config():
    return ExperimentConfig(
        model=default_config(max_points=1024, voxel_capacity=1024, max_superpoints=64,
                             num_planes=(8, 16), d_model=32, num_heads=2, hidden_dim=32,
                             num_layers=1, compute_dtype="float32"),
        datasets=(DatasetSpec(name="scannet", data_root="."),))
"""


def test_cli_params_config_and_points(tmp_path):
    from unidet3d_tpu_torch.core.experiment import load_experiment
    from unidet3d_tpu_torch.data.synthetic import synthetic_scene
    from unidet3d_tpu_torch.train.checkpoint import save_params
    from unidet3d_tpu_torch.train.loop import build_model
    from unidet3d_tpu_torch.weights import seeded_init_

    cfg = tmp_path / "tiny.py"
    cfg.write_text(CONFIG)
    pts = synthetic_scene(900, seed=4)
    pts.tofile(tmp_path / "scene.bin")
    common = ["--config", str(cfg), "--points", str(tmp_path / "scene.bin"), "--device", "cpu"]
    seeded = rec_tool.main([str(tmp_path / "a.npz"), "--seed", "3", *common])
    assert seeded["inter/backbone/__call__/0"].shape == (1024, 8)
    assert seeded["out/boxes"].shape == (2, 1, 64, 7)
    # The same weights through --params: the same probes.
    net, _ = build_model(load_experiment(str(cfg)), device="cpu")
    save_params(str(tmp_path / "w.pth"), seeded_init_(net, 3).state_dict())
    loaded = rec_tool.main([str(tmp_path / "b.npz"), "--params", str(tmp_path / "w.pth"),
                            "--seed", "3", *common])
    for name, v in seeded.items():
        np.testing.assert_array_equal(loaded[name], v, err_msg=name)
    # Other weights: other probes.
    other = rec_tool.main([str(tmp_path / "c.npz"), "--seed", "4", *common])
    assert not np.array_equal(other["out/cls_logits"], seeded["out/cls_logits"])
    if not torch.cuda.is_available():  # the card by default
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            rec_tool.main([str(tmp_path / "d.npz"), *common[:4]])
