"""The port's conv-bottleneck probe against the JAX package, on the CPU: the
probe's scene and level-0 table, the ``full`` mode against the TPU banded
conv (interpret mode), each stripped mode against a numpy evaluation of its
formula over the JAX package's table, and the work counts the probe's bounds
divide by.

Inputs come from numpy seeds and go through both packages; CPU tensors make
the probe's wrapper run its plain versions. Each comparison states its
tolerance.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from unidet3d_tpu_torch.ops.probe_conv import (
    MODES,
    probe_conv_cuda,
    probe_conv_plain,
    probe_work,
)
from unidet3d_tpu_torch.tools import probe_conv_bottleneck as tool

CAP = 4096  # points of the small probe scene, and its voxel capacity


@pytest.fixture(scope="module")
def jax_scene_table():
    """What the JAX probe builds (scripts/probe_conv_bottleneck.py::main),
    at a small cap: synthetic_scene(cap, seed=5) -> quantize_points ->
    build_gridpack_host, level 0."""
    from unidet3d_tpu.core.config import ModelConfig
    from unidet3d_tpu.data.synthetic import synthetic_scene
    from unidet3d_tpu.ops.gridpack import build_gridpack_host, quantize_points

    cfg = ModelConfig(max_points=CAP, voxel_capacity=CAP)
    sc = synthetic_scene(CAP, seed=5)
    vox_src = (sc[None, :, :3] / cfg.voxel_size).astype(np.float32)
    valid = np.ones((1, len(sc)), bool)
    pack, _ = build_gridpack_host(quantize_points(vox_src, valid), valid.reshape(-1), [CAP])
    return sc, np.asarray(pack.neighbors[0]), int(np.asarray(pack.valid[0]).sum())


def test_probe_scene_and_table_match_the_jax_probe(jax_scene_table):
    points, nbr, n_valid = tool.probe_table(CAP)
    ref_points, ref_nbr, ref_n = jax_scene_table
    np.testing.assert_array_equal(points, ref_points)
    np.testing.assert_array_equal(nbr, ref_nbr)
    assert n_valid == ref_n
    assert nbr.dtype == np.int32 and nbr.shape == (CAP, 27)


def _banded_full(nbr, n_valid, feat, w):
    """The JAX package's banded conv, subm_conv_banded(window, None, True, 1,
    ...) in interpret mode, over a rulebook of `nbr` whose 256-row window
    leaves misses, so that the miss list runs too."""
    from unidet3d_tpu.ops.pallas_conv import (
        build_banded_rulebook,
        build_miss_list,
        subm_conv_banded,
    )

    cap, window = nbr.shape[0], 256
    rb = build_banded_rulebook(nbr, cap, block=128, window=window)
    assert rb.n_miss > 0
    ml = build_miss_list(rb.miss_idx, cap, miss_cap=4096)
    tables = [jnp.asarray(x) for x in (rb.bases, rb.rel, rb.sub_offs, rb.active,
                                        ml.rows, ml.nbrs, ml.offs)]
    out = subm_conv_banded(window, None, True, 1, feat, w, *tables)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["int", "bf16"])
def test_probe_full_matches_the_banded_conv(jax_scene_table, dtype):
    _, nbr, n_valid = jax_scene_table
    rng = np.random.RandomState(1)
    if dtype == "int":
        feat = rng.randint(-3, 4, (CAP, 32)).astype(np.float32)
        w = rng.randint(-2, 3, (27, 32, 32)).astype(np.float32)
        ref = _banded_full(nbr, n_valid, jnp.asarray(feat), jnp.asarray(w))
        mine = probe_conv_cuda("full", torch.from_numpy(feat), torch.from_numpy(nbr),
                               torch.from_numpy(w), n_valid)
        # Small integers in fp32: every product and sum is exact on both sides.
        np.testing.assert_array_equal(mine.numpy()[:n_valid], ref[:n_valid])
    else:
        feat = rng.randn(CAP, 32).astype(np.float32)
        w = (rng.randn(27, 32, 32) * 0.1).astype(np.float32)
        ref = _banded_full(nbr, n_valid, jnp.asarray(feat, jnp.bfloat16),
                           jnp.asarray(w, jnp.bfloat16))
        mine = probe_conv_cuda("full", torch.from_numpy(feat).bfloat16(),
                               torch.from_numpy(nbr), torch.from_numpy(w).bfloat16(),
                               n_valid)
        # The same bf16 products; fp32 sums in another order on both sides.
        np.testing.assert_allclose(mine.numpy()[:n_valid], ref[:n_valid],
                                   rtol=1e-3, atol=1e-3)
    assert np.all(mine.numpy()[n_valid:] == 0)


def _numpy_formula(mode, feat, nbr, w, n):
    """Each stripped mode's formula in float64, row by row over the table."""
    v, cin = feat.shape
    out = np.zeros((v, w.shape[2]))
    for i in range(n):
        for o in range(27):
            j = nbr[i, o]
            has = 0 <= j < v
            if mode == "gather_only":
                out[i] += feat[j] if has else 0.0
            elif mode == "no_gather":
                out[i] += feat[i] @ w[o] if has else 0.0
            else:  # no_table
                out[i] += feat[i] @ w[o]
    return out


@pytest.mark.parametrize("mode", ["gather_only", "no_gather", "no_table"])
def test_stripped_modes_match_their_formula_on_the_jax_table(jax_scene_table, mode):
    _, nbr, n_valid = jax_scene_table
    rng = np.random.RandomState(2)
    feat = rng.randn(CAP, 32).astype(np.float32)
    w = (rng.randn(27, 32, 32) * 0.1).astype(np.float32)
    mine = probe_conv_cuda(mode, torch.from_numpy(feat), torch.from_numpy(nbr),
                           torch.from_numpy(w), n_valid).numpy()
    ref = _numpy_formula(mode, feat.astype(np.float64), nbr, w.astype(np.float64), n_valid)
    # fp32 sums of up to 27 x 32 products against float64: 1e-5 of the
    # output's scale.
    np.testing.assert_allclose(mine, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


def _numpy_work(mode, nbr, n, cin, cout, itemsize):
    """probe_work's counts, tile by tile over the table."""
    v = nbr.shape[0]
    tile_offsets = pairs = 0
    gathered, own = set(), set()
    for t0 in range(0, n, 64):
        rows = nbr[t0:min(t0 + 64, n)]
        for o in range(27):
            hit = (rows[:, o] >= 0) & (rows[:, o] < v)
            if mode == "no_table":
                tile_offsets += 1
                pairs += len(rows)
            elif hit.any():
                tile_offsets += 1
                pairs += int(hit.sum())
                gathered.update(rows[hit, o].tolist())
                own.update((t0 + np.flatnonzero(hit)).tolist())
    distinct = {"full": len(gathered), "gather_only": len(gathered),
                "no_gather": len(own), "no_table": n}[mode]
    # What the function needs: a product per existing pair (an add per
    # element for gather_only); no_table one product per row with sum_o W[o].
    ops = {"gather_only": pairs * cin,
           "no_table": 2 * n * cin * cout + 26 * cin * cout}.get(mode, 2 * pairs * cin * cout)
    table = 0 if mode == "no_table" else n * 27 * 4
    w_tile = 0 if mode == "gather_only" else cin * cout * itemsize
    col_blocks = -(-cout // (32 if cout <= 32 else 64))
    return dict(
        tile_offsets=tile_offsets, pairs=pairs,
        fmas=0 if mode == "gather_only" else pairs * cin * cout,
        adds=pairs * cin if mode == "gather_only" else 0,
        ops=ops,
        peak_flops={2: 989e12, 4: 67e12}[itemsize],
        bytes_read=table + distinct * cin * itemsize + 27 * w_tile,
        bytes_written=v * cout * 4,
        bytes_loaded=col_blocks * (table + pairs * cin * itemsize) + tile_offsets * w_tile,
    )


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("cout,itemsize", [(32, 2), (96, 4)])
def test_probe_work_counts_match_numpy(jax_scene_table, mode, cout, itemsize):
    _, nbr, n_valid = jax_scene_table
    cin = cout
    work = probe_work(mode, nbr, n_valid, cin, cout, itemsize)
    assert work._asdict() == _numpy_work(mode, nbr, n_valid, cin, cout, itemsize)
    # The same counts from a tensor table.
    assert probe_work(mode, torch.from_numpy(nbr), n_valid, cin, cout, itemsize) == work
    bound_ms, by = work.bound()
    bytes_ms = (work.bytes_read + work.bytes_written) / 3.35e12 * 1e3
    assert bound_ms == max(bytes_ms, work.ops / work.peak_flops * 1e3)
    assert by == ("bytes" if bytes_ms == bound_ms else "operations")
    assert work.fp32_unit_ms() == (2 * work.fmas + work.adds) / 67e12 * 1e3


@pytest.mark.parametrize("mode", MODES)
def test_library_calls_compute_each_mode(jax_scene_table, mode):
    _, nbr, n_valid = jax_scene_table
    rng = np.random.RandomState(3)
    inputs = tool.ProbeInputs(
        features=torch.from_numpy(rng.randn(CAP, 32).astype(np.float32)),
        neighbors=torch.from_numpy(nbr),
        weights=torch.from_numpy((rng.randn(27, 32, 32) * 0.1).astype(np.float32)),
        n_valid=n_valid,
    )
    _, call = tool.library_calls(inputs)[mode]
    ref = probe_conv_plain(mode, *inputs)[:n_valid]
    # fp32 sums of the same products in another order.
    torch.testing.assert_close(call(), ref, rtol=1e-5, atol=1e-5 * ref.abs().max().item())


def test_probe_counts_no_launch_on_cpu_and_needs_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tool.main()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tool.probe_inputs(1024)
    before = dict(probe_conv_cuda.launches)
    res = tool.main(device="cpu", cap=1024)
    assert probe_conv_cuda.launches == before
    assert set(res) == set(MODES)
    for r in res.values():  # the CPU checks and counts, and times nothing
        assert r["ms"] is None and r["max_abs_err"] == 0.0 and r["bound_ms"] > 0


def test_probe_rejects_bad_modes():
    feat, nbr = torch.zeros(8, 4), torch.full((8, 27), 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="mode"):
        probe_conv_plain("dma_only", feat, nbr, torch.zeros(27, 4, 4), 8)
    with pytest.raises(ValueError, match="Cin 4 != Cout 8"):
        probe_conv_plain("gather_only", feat, nbr, torch.zeros(27, 4, 8), 8)
