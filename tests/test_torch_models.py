"""The port's backbone, decoder and post-processing against the JAX package
at reduced widths, on the CPU, fp32.

The flax variables are perturbed with seeded noise (the default init has
identity norms and zero biases, which would hide a wrong mapping) and go
into the port through ``weights.from_flax``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unidet3d_tpu_torch.weights import from_flax


def _t(x):
    return torch.from_numpy(np.array(x))


def _perturb(variables, seed):
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        x = np.asarray(x)
        if path[-1].key == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return (x + 0.1 * rng.randn(*x.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, jax.device_get(variables))


def test_backbone_matches_jax_reduced_width():
    from unidet3d_tpu.models.unet import UNetBackbone as JaxBackbone
    from unidet3d_tpu.ops import gridpack as jgp

    from unidet3d_tpu_torch.data.synthetic import synthetic_scene
    from unidet3d_tpu_torch.data.batcher import to_device
    from unidet3d_tpu_torch.models.detector import PointBatch
    from unidet3d_tpu_torch.models.unet import UNetBackbone
    from unidet3d_tpu_torch.ops.gridpack import build_gridpack_numpy, quantize_points

    planes = (8, 16, 24)
    caps = [2048, 1024, 1024]
    pts = synthetic_scene(2000, seed=3)[:, :3]
    valid = np.ones((1, 2000), bool)
    bxyz = quantize_points((pts[None] / 0.02).astype(np.float32), valid)
    jpack, _ = jgp.build_gridpack_numpy(bxyz, valid.reshape(-1), caps)
    pack, _ = build_gridpack_numpy(bxyz, valid.reshape(-1), caps)
    rng = np.random.RandomState(0)
    feats = rng.randn(caps[0], 6).astype(np.float32)
    feats[pack.n_valid[0]:] = 0.0

    jmod = JaxBackbone(planes, dtype=jnp.float32, remat=False)
    jpack = jax.tree_util.tree_map(jnp.asarray, jpack)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(feats), jpack, False)
    variables = _perturb(variables, 1)
    ref = np.asarray(jmod.apply(variables, jnp.asarray(feats), jpack, False))

    mod = UNetBackbone(6, planes, torch.float32)
    mod.load_state_dict(from_flax(variables))
    dummy = PointBatch(*(np.zeros(1) for _ in PointBatch._fields))
    _, tpack = to_device(dummy, pack, "cpu")
    with torch.no_grad():
        mine = mod(_t(feats), tpack).numpy()
    # fp32 both sides; summation order differs through 15 convs.
    np.testing.assert_allclose(mine, ref, rtol=1e-4, atol=1e-4)


def _decoder_inputs():
    rng = np.random.RandomState(2)
    b, q, cin = 2, 40, 16
    queries = rng.randn(b, q, cin).astype(np.float32)
    mask = rng.rand(b, q) > 0.3
    centers = (rng.rand(b, q, 3) * 4).astype(np.float32)
    ds = np.array([0, 5], np.int32)  # axis-aligned and rotated decode
    return queries, mask, centers, ds


_DECODER_KW = dict(num_layers=2, d_model=64, num_heads=2, hidden_dim=128, activation="gelu")


def _port_decoder(dropout=0.0):
    from unidet3d_tpu_torch.core.class_table import build_class_table
    from unidet3d_tpu_torch.core.config import DATASETS_CLASSES, default_config
    from unidet3d_tpu_torch.models.decoder import UniDecoder

    return UniDecoder(in_channels=16, cls_gather=build_class_table(DATASETS_CLASSES).gather,
                      angles=default_config().angles, dtype=torch.float32, dropout=dropout,
                      **_DECODER_KW)


def _jax_decoder_parity(dropout):
    """The flax decoder and the port's at `dropout`, on the same perturbed
    weights (through from_flax), both out of training: valid query rows
    within the fp32 tolerance."""
    from unidet3d_tpu.models.decoder import UniDecoder as JaxDecoder

    from unidet3d_tpu_torch.core.class_table import build_class_table
    from unidet3d_tpu_torch.core.config import DATASETS_CLASSES, default_config

    cfg = default_config()
    table = build_class_table(DATASETS_CLASSES)
    queries, mask, centers, ds = _decoder_inputs()
    args = (jnp.asarray(queries), jnp.asarray(mask), jnp.asarray(centers),
            jnp.asarray(ds))
    jmod = JaxDecoder(dropout=dropout, cls_gather=table.gather, angles=cfg.angles,
                      dtype=jnp.float32, **_DECODER_KW)
    variables = _perturb(jmod.init(jax.random.PRNGKey(0), *args, False), 3)
    ref = jmod.apply(variables, *args, False)

    mod = _port_decoder(dropout)
    mod.load_state_dict(from_flax(variables))
    with torch.no_grad():
        out = mod(_t(queries), _t(mask), _t(centers), _t(ds))
    # Valid query rows only; fp32 attention, GELU(tanh), LayerNorm eps 1e-6.
    for name in ("cls_logits", "boxes"):
        np.testing.assert_allclose(
            getattr(out, name).numpy()[:, mask], np.asarray(getattr(ref, name))[:, mask],
            rtol=1e-4, atol=1e-4, err_msg=name,
        )


def test_decoder_matches_jax_reduced_width():
    _jax_decoder_parity(0.0)


def test_decoder_with_dropout_matches_jax_out_of_training():
    """At dropout 0.3 and train=False neither decoder drops anything."""
    _jax_decoder_parity(0.3)


def test_decoder_without_dropout_trains_with_todays_bits():
    """At dropout 0 (every config), train=True draws nothing from the
    generator and gives the eval forward's bits."""
    from unidet3d_tpu_torch.core.class_table import build_class_table
    from unidet3d_tpu_torch.core.config import DATASETS_CLASSES, default_config
    from unidet3d_tpu_torch.models.detector import UniDet3D
    from unidet3d_tpu_torch.weights import seeded_init_

    mod = seeded_init_(_port_decoder(0.0), 0)
    inputs = [_t(x) for x in _decoder_inputs()]
    gen = torch.Generator().manual_seed(7)
    state = gen.get_state()
    with torch.no_grad():
        ref = mod(*inputs)
        out = mod(*inputs, train=True, generator=gen)
    assert torch.equal(gen.get_state(), state)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    # The detector hands the config's rate to every dropout point.
    net = UniDet3D(default_config(dropout=0.25), build_class_table(DATASETS_CLASSES),
                   device="cpu")
    assert {m.rate for name, m in net.decoder.named_children()
            if name.startswith(("attn", "ffn"))} == {0.25}


def test_dropout_keeps_its_share_scaled_and_repeats():
    """flax nn.Dropout at 0.5: about half the values kept, each doubled, the
    rest 0; equally seeded generators give the same masks; the decoder in
    training then differs from its eval forward and repeats bit for bit."""
    from unidet3d_tpu_torch.models.decoder import dropout
    from unidet3d_tpu_torch.weights import seeded_init_

    x = torch.full((1000, 1000), 3.0)
    out = dropout(x, 0.5, torch.Generator().manual_seed(1))
    kept = out != 0
    assert abs(kept.float().mean().item() - 0.5) <= 0.01
    assert torch.all(out[kept] == 6.0)
    assert torch.equal(out, dropout(x, 0.5, torch.Generator().manual_seed(1)))
    assert not torch.equal(out, dropout(x, 0.5, torch.Generator().manual_seed(2)))

    mod = seeded_init_(_port_decoder(0.5), 0)
    inputs = [_t(v) for v in _decoder_inputs()]
    with torch.no_grad():
        ref = mod(*inputs)
        runs = [mod(*inputs, train=True, generator=torch.Generator().manual_seed(3))
                for _ in range(2)]
    assert torch.equal(runs[0].cls_logits, runs[1].cls_logits)
    assert not torch.equal(runs[0].cls_logits, ref.cls_logits)


def _post_inputs(seed, q=64, p=3000):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(q, 85) * 3).astype(np.float32)
    logits[:, 18:84] = -1e9  # ScanNet-like padding of the class columns
    boxes = np.concatenate(
        [rng.rand(q, 3) * 3, 0.3 + rng.rand(q, 3), np.zeros((q, 1))], 1
    ).astype(np.float32)
    qvalid = rng.rand(q) > 0.2
    points = (rng.rand(p, 3) * 3).astype(np.float32)
    pvalid = np.arange(p) < p - 200
    # Superpoints: 8 x 8 x 8 spatial cells of 0.375 m, S = 512.
    cell = np.floor(points / 0.375).astype(np.int32).clip(0, 7)
    sp_ids = cell[:, 0] * 64 + cell[:, 1] * 8 + cell[:, 2]
    return logits, boxes, qvalid, points, pvalid, sp_ids


@pytest.mark.parametrize("dataset_idx", [0, 2])
def test_predict_scene_matches_jax(dataset_idx):
    from unidet3d_tpu.core.config import default_config as jax_config
    from unidet3d_tpu.models.postprocess import predict_scene as jax_predict_scene

    from unidet3d_tpu_torch.core.config import default_config
    from unidet3d_tpu_torch.models.postprocess import predict_batch, predict_scene

    kw = dict(max_superpoints=512)
    inputs = _post_inputs(dataset_idx)
    ref = jax_predict_scene(jax_config(**kw), dataset_idx,
                            *(jnp.asarray(x) for x in inputs))
    cfg = default_config(**kw)
    mine = predict_scene(cfg, dataset_idx, *(_t(x) for x in inputs))
    keep = np.asarray(ref.valid)
    assert keep.any()
    np.testing.assert_array_equal(mine.valid.numpy(), keep)
    # Labels of scored detections: past them the top-k ties at probability
    # 0 (masked class columns) and either order is right.
    scored = np.asarray(ref.scores) > 0
    np.testing.assert_array_equal(mine.labels.numpy()[scored],
                                  np.asarray(ref.labels)[scored])
    # Softmax scores in fp32; trimmed boxes are min/max of the same points.
    np.testing.assert_allclose(mine.scores.numpy(), np.asarray(ref.scores),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(mine.boxes.numpy()[keep], np.asarray(ref.boxes)[keep],
                               rtol=1e-5, atol=1e-5)
    batched = predict_batch(cfg, dataset_idx, *(_t(x)[None] for x in inputs))
    np.testing.assert_array_equal(batched.valid[0].numpy(), keep)


def test_predict_scene_rotated_dataset_not_ported():
    """Formerly: a rotated dataset raised. ARKitScenes (dataset 5) is ported
    now (tests/test_torch_indoor_eval.py holds it against the JAX package):
    its detections keep their query's yaw, where the others' is zeroed."""
    from unidet3d_tpu_torch.core.config import default_config
    from unidet3d_tpu_torch.models.postprocess import predict_scene

    logits, boxes, *rest = _post_inputs(0)
    boxes[:, 6] = np.random.RandomState(1).uniform(-np.pi, np.pi, len(boxes))
    det = predict_scene(default_config(), 5, _t(logits), _t(boxes), *(_t(x) for x in rest))
    assert det.valid.any()
    yaws = set(np.round(boxes[:, 6], 6).tolist())
    assert set(np.round(det.boxes[det.valid, 6].numpy(), 6).tolist()) <= yaws
    assert det.boxes[det.valid, 6].abs().max() > 0
    aa = predict_scene(default_config(), 2, _t(logits), _t(boxes), *(_t(x) for x in rest))
    assert torch.all(aa.boxes[:, 6] == 0)


def test_from_flax_rejects_unknown_leaves():
    with pytest.raises(ValueError, match="no counterpart"):
        from_flax({"params": {"decoder": {"mystery": np.zeros(3)}}})
    with pytest.raises(ValueError, match="collection"):
        from_flax({"cache": {}})
