"""The port's training ops against the JAX package, on the CPU: the
differentiable submanifold conv (K1 forward, K1' input gradient, K2 weight
gradient), the attention backward, the train branch of the masked batch norm
and the optimizer.

Inputs come from numpy seeds and go through both packages; CPU tensors make
the port's wrappers run their plain versions. Each comparison states its
tolerance.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unidet3d_tpu_torch.ops.attention import (
    FlashAttentionFunction,
    attention_bwd_plain,
    attention_plain,
    flash_attention_dkv_cuda,
    flash_attention_dq_cuda,
)
from unidet3d_tpu_torch.ops.gridpack import build_gridpack_numpy, quantize_points
from unidet3d_tpu_torch.ops.sparse_conv import subm_conv, subm_conv_dgrad, subm_conv_wgrad
from unidet3d_tpu_torch.ops.subm_conv_cuda import (
    SubmConvFunction,
    subm_conv_dgrad_cuda,
    subm_conv_wgrad_cuda,
)


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------- conv autograd Function


def _banded_setup(cin, cout, seed=7, window=128):
    """The JAX test's voxel grid (tests/test_pallas_conv.py::_setup), its
    neighbor table, and a banded rulebook: the narrow default window leaves
    misses, 1024 covers the whole table."""
    from unidet3d_tpu.ops.pallas_conv import build_banded_rulebook, build_miss_list
    from unidet3d_tpu.ops.sparse_conv import build_subm_neighbors
    from unidet3d_tpu.ops.voxelize import voxelize

    rng = np.random.RandomState(13)
    n, cap = 900, 1024
    bxyz = np.concatenate(
        [rng.randint(0, 2, (n, 1)), rng.randint(0, 14, (n, 3))], axis=1
    ).astype(np.int32)
    grid, _ = voxelize(jnp.array(bxyz), jnp.ones(n, bool), cap,
                       jnp.array(rng.randn(n, cin).astype(np.float32)))
    nbr = np.asarray(build_subm_neighbors(grid))
    rb = build_banded_rulebook(nbr, cap, block=128, window=window)
    assert (rb.n_miss > 0) == (window < cap)
    ml = build_miss_list(rb.miss_idx, cap, miss_cap=4096)
    banded = (window,) + tuple(jnp.asarray(x) for x in (
        rb.bases, rb.rel, rb.sub_offs, rb.active, ml.rows, ml.nbrs, ml.offs))
    return nbr, int(grid.n_voxels), banded, np.random.RandomState(seed)


def _jax_banded_value_and_grads(feat, w, gdir, banded):
    from unidet3d_tpu.ops.pallas_conv import subm_conv_banded

    window, *tables = banded

    def loss(f, weights):
        out = subm_conv_banded(window, None, True, 1, f, weights, *tables)
        return jnp.sum(out * gdir)

    v, (gf, gw) = jax.value_and_grad(loss, argnums=(0, 1))(feat, w)
    return float(v), np.asarray(gf.astype(jnp.float32)), np.asarray(gw)


def _port_value_and_grads(feat, w, gdir, nbr, nv):
    feat = feat.clone().requires_grad_(True)
    w = w.clone().requires_grad_(True)
    out = SubmConvFunction.apply(feat, nbr, w, nv)
    loss = (out * gdir).sum()
    loss.backward()
    return float(loss.detach()), feat.grad.float().numpy(), w.grad.numpy(), w.grad.dtype


def test_conv_function_matches_banded_vjp_exactly_on_integers():
    cin, cout = 8, 16
    # The narrow window: the TPU kernel's miss path runs in fwd and bwd.
    nbr, nv, banded, rng = _banded_setup(cin, cout)
    cap = nbr.shape[0]
    feat = rng.randint(-3, 4, (cap, cin)).astype(np.float32)
    feat[nv:] = 0.0
    w = rng.randint(-2, 3, (27, cin, cout)).astype(np.float32)
    gdir = rng.randint(-2, 3, (cap, cout)).astype(np.float32)
    gdir[nv:] = 0.0
    ref = _jax_banded_value_and_grads(jnp.asarray(feat), jnp.asarray(w),
                                      jnp.asarray(gdir), banded)
    mine = _port_value_and_grads(_t(feat), _t(w), _t(gdir), _t(nbr), nv)
    # Small integers in fp32: every product and sum is exact on both sides.
    np.testing.assert_allclose(mine[0], ref[0], rtol=1e-5)
    np.testing.assert_allclose(mine[1], ref[1], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(mine[2], ref[2], rtol=1e-5, atol=1e-5)


def test_conv_function_bf16_rounds_like_the_tpu_kernel():
    cin, cout = 8, 16
    # A window over the whole table: no misses, so the TPU version rounds g
    # to bf16 everywhere (its miss-list term would take g in fp32).
    nbr, nv, banded, rng = _banded_setup(cin, cout, seed=8, window=1024)
    cap = nbr.shape[0]
    feat = rng.randn(cap, cin).astype(np.float32)
    feat[nv:] = 0.0
    w = (rng.randn(27, cin, cout) / np.sqrt(27 * cin)).astype(np.float32)
    gdir = rng.randn(cap, cout).astype(np.float32)
    gdir[nv:] = 0.0
    ref = _jax_banded_value_and_grads(jnp.asarray(feat, jnp.bfloat16),
                                      jnp.asarray(w), jnp.asarray(gdir), banded)
    val, dfeat, dw, dw_dtype = _port_value_and_grads(
        _t(feat).bfloat16(), _t(w), _t(gdir), _t(nbr), nv)
    # The fp32 master weight gets an fp32 gradient (not rounded to bf16).
    assert dw_dtype == torch.float32
    # bf16 features, weights and cotangent (g rounded to bf16 before K1' and
    # K2, as the TPU kernel's g.astype(dtype)); fp32 sums in another order;
    # dfeat is returned in bf16 (8-bit mantissa).
    np.testing.assert_allclose(val, ref[0], rtol=1e-2)
    np.testing.assert_allclose(dfeat, ref[1], rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(dw, ref[2], rtol=1e-2, atol=1e-2)
    # K2's plain version on the bf16-rounded cotangent is what was returned.
    g_bf16 = _t(gdir).bfloat16()
    exact = subm_conv_wgrad(_t(feat).bfloat16(), _t(nbr), g_bf16, nv)
    np.testing.assert_allclose(dw, exact.numpy(), rtol=1e-6, atol=1e-6)


def test_input_conv_skips_dgrad_and_counts_nothing_on_cpu():
    nbr, nv, _, rng = _banded_setup(6, 8)
    feat = _t(rng.randn(nbr.shape[0], 6).astype(np.float32))  # data: no grad
    w = _t(rng.randn(27, 6, 8).astype(np.float32)).requires_grad_(True)
    before = (subm_conv_dgrad_cuda.launches, subm_conv_wgrad_cuda.launches)
    SubmConvFunction.apply(feat, _t(nbr), w, nv).sum().backward()
    assert feat.grad is None and w.grad.shape == (27, 6, 8)
    assert (subm_conv_dgrad_cuda.launches, subm_conv_wgrad_cuda.launches) == before


# ------------------------------------------------------------ table symmetry


@pytest.mark.parametrize("level", [0, 1])
def test_mirrored_dgrad_is_the_exact_transpose_on_gridpack_tables(level):
    from unidet3d_tpu_torch.data.synthetic import synthetic_scene

    n = 2500
    pts = np.stack([synthetic_scene(n, seed=40 + i)[:, :3] for i in range(2)])
    valid = np.ones(pts.shape[:2], bool)
    valid[1, n - 400:] = False  # ragged second scene
    caps = (8192, 8192)  # padding past the valid rows at both levels
    pack, _ = build_gridpack_numpy(
        quantize_points((pts / 0.02).astype(np.float32), valid),
        valid.reshape(-1), caps)
    nbr, nv = pack.neighbors[level], pack.n_valid[level]
    v = nbr.shape[0]
    assert 0 < nv < v

    # Structural symmetry: pair (i, j, o) <=> (j, i, 26 - o).
    i, o = np.nonzero(nbr[:nv] < v)
    np.testing.assert_array_equal(nbr[nbr[i, o], 26 - o], i)
    assert (nbr[nv:] == v).all()

    rng = np.random.RandomState(level)
    cin, cout = 12, 20
    feat = _t(rng.randn(v, cin).astype(np.float32)).requires_grad_(True)
    w = _t(rng.randn(27, cin, cout).astype(np.float32))
    g = _t(rng.randn(v, cout).astype(np.float32))
    (subm_conv(feat, _t(nbr), w, nv) * g).sum().backward()
    mirrored = subm_conv_dgrad(g, _t(nbr), w, nv)
    # fp32 sums of the same products in another order.
    np.testing.assert_allclose(mirrored.numpy(), feat.grad.numpy(),
                               rtol=1e-5, atol=1e-5)
    assert torch.all(mirrored[nv:] == 0)
    # The CPU wrapper of K1' runs this plain version.
    torch.testing.assert_close(subm_conv_dgrad_cuda(g, _t(nbr), w, nv), mirrored)
    # And K2's: autograd's weight gradient of the plain conv.
    w_req = w.clone().requires_grad_(True)
    (subm_conv(feat.detach(), _t(nbr), w_req, nv) * g).sum().backward()
    np.testing.assert_allclose(
        subm_conv_wgrad_cuda(feat.detach(), _t(nbr), g, nv).numpy(),
        w_req.grad.numpy(), rtol=1e-5, atol=1e-4)


# -------------------------------------------------------- attention backward


def test_attention_backward_matches_jax_reference_vjp():
    from jax.experimental.pallas.ops.tpu.flash_attention import (
        SegmentIds,
        mha_reference_no_custom_vjp,
    )

    rng = np.random.RandomState(3)
    b, h, length, d = 2, 3, 70, 32
    q, k, v, do = (rng.randn(b, h, length, d).astype(np.float32) for _ in range(4))
    seg = np.full((b, length), 2, np.int32)
    seg[0, :61] = 1
    seg[1, :23] = 1
    scale = d ** -0.5

    def ref_fn(q_, k_, v_):
        return mha_reference_no_custom_vjp(
            q_, k_, v_, segment_ids=SegmentIds(jnp.asarray(seg), jnp.asarray(seg)),
            sm_scale=scale)

    ref_o, vjp = jax.vjp(ref_fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = [np.asarray(x) for x in vjp(jnp.asarray(do))]

    tq, tk, tv, tdo, tseg = _t(q), _t(k), _t(v), _t(do), _t(seg)
    # The plain backward from the forward's lse and di = rowsum(o * do).
    o, lse = attention_plain(tq, tk, tv, tseg, scale, return_lse=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(ref_o), rtol=1e-5, atol=1e-5)
    di = (o * tdo).sum(-1)
    plain = attention_bwd_plain(tq, tk, tv, tseg, tdo, lse, di, scale)
    # The CPU wrappers of K3-dkv and K3-dq run it too.
    wrapped = (flash_attention_dq_cuda(tq, tk, tv, tseg, tdo, lse, di, scale),
               *flash_attention_dkv_cuda(tq, tk, tv, tseg, tdo, lse, di, scale))
    # Autograd through attention_plain, and through the Function.
    leaves = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
    (attention_plain(*leaves, tseg, scale) * tdo).sum().backward()
    auto = [x.grad for x in leaves]
    fleaves = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
    (FlashAttentionFunction.apply(*fleaves, tseg, scale) * tdo).sum().backward()
    func = [x.grad for x in fleaves]
    # fp32 on every side, all rows (the segment semantics are the same);
    # sums in another order.
    for name, grads in (("plain", plain), ("wrappers", wrapped),
                        ("autograd", auto), ("function", func)):
        for mine, r, which in zip(grads, ref, "qkv"):
            np.testing.assert_allclose(mine.numpy(), r, rtol=1e-5, atol=1e-5,
                                       err_msg=f"{name} d{which}")


# ------------------------------------------------------------ train-mode BN


def test_masked_batchnorm_train_branch_matches_jax():
    from unidet3d_tpu.models.norm import MaskedBatchNorm as JaxBN

    from unidet3d_tpu_torch.models.norm import MaskedBatchNorm

    rng = np.random.RandomState(11)
    n, c = 300, 24
    x = (rng.randn(n, c) * 2 + 0.5).astype(np.float32)
    mask = np.arange(n) < 217
    x[217:] = rng.randn(n - 217, c) * 50  # padding rows must not count
    gdir = rng.randn(n, c).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.randn(c).astype(np.float32)
    mean0 = rng.randn(c).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, c).astype(np.float32)

    jmod = JaxBN(c)
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}}

    def loss(params, xx):
        out, mut = jmod.apply({"params": params, "batch_stats": variables["batch_stats"]},
                              xx, jnp.asarray(mask), False, mutable=["batch_stats"])
        return jnp.sum(out * gdir), (out, mut["batch_stats"])

    (_, (ref_out, ref_stats)), (gp, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(variables["params"], jnp.asarray(x))

    bn = MaskedBatchNorm(c)
    with torch.no_grad():
        bn.weight.copy_(_t(scale))
        bn.bias.copy_(_t(bias))
        bn.running_mean.copy_(_t(mean0))
        bn.running_var.copy_(_t(var0))
    tx = _t(x).requires_grad_(True)
    out = bn(tx, _t(mask), train=True)
    (out * _t(gdir)).sum().backward()
    # fp32 moments of the same rows; sums in another order.
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out), **tol)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), **tol)
    np.testing.assert_allclose(bn.weight.grad.numpy(), np.asarray(gp["scale"]), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(bn.bias.grad.numpy(), np.asarray(gp["bias"]), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(ref_stats["mean"]), **tol)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(ref_stats["var"]), **tol)
    # The eval branch still uses the (now updated) running statistics.
    with torch.no_grad():
        ev = bn(_t(x))
    expect = (_t(x) - bn.running_mean) * torch.rsqrt(bn.running_var + 1e-4) * bn.weight + bn.bias
    torch.testing.assert_close(ev, expect)


# ----------------------------------------------------------------- optimizer


def test_optimizer_matches_optax_on_given_gradients():
    import optax

    from unidet3d_tpu.train.optim import make_optimizer as jax_make_optimizer

    from unidet3d_tpu_torch.train.optim import make_optimizer

    rng = np.random.RandomState(5)
    shapes = {"a": (7, 5), "b": (13,), "c": (3, 4, 2)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    # Three steps; the second has |g| > 10, so it is clipped.
    grads = [{k: (rng.randn(*s) * f).astype(np.float32) for k, s in shapes.items()}
             for f in (0.3, 8.0, 0.05)]
    kw = dict(base_lr=2e-2, weight_decay=0.05, total_steps=10, power=0.9,
              clip_norm=10.0)

    opt = jax_make_optimizer(**kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(jp)
    torch_params = {k: torch.nn.Parameter(_t(v)) for k, v in params.items()}
    mine = make_optimizer(torch_params.values(), **kw)
    norms = []
    for g in grads:
        jg = {k: jnp.asarray(v) for k, v in g.items()}
        updates, state = opt.update(jg, state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in torch_params.items():
            p.grad = _t(g[k])
        norms.append((float(mine.step()), float(optax.global_norm(jg))))
        for k, p in torch_params.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-6, err_msg=k)
    assert norms[1][1] > 10.0
    for got, want in norms:
        np.testing.assert_allclose(got, want, rtol=1e-6)
