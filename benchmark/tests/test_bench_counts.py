"""The yardstick's arithmetic against hand counts on a tiny neighbour table."""
import numpy as np
import pytest

from benchmark.harness import counts, readers


def tiny_shape():
    # Level 0: 4 rows, 3 valid, the sentinel is 4; level 1: 2 rows, 1 valid.
    nbr0 = np.full((4, 27), 4)
    nbr0[0, [0, 13]] = [1, 0]
    nbr0[1, [13, 26]] = [1, 0]
    nbr0[2, 13] = 2
    nbr0[3, 13] = 3  # a padded row: not counted
    nbr1 = np.full((2, 27), 2)
    nbr1[0, 13] = 0
    levels = (counts.LevelShape(4, 3, counts.pairs_of(nbr0, 3)),
              counts.LevelShape(2, 1, counts.pairs_of(nbr1, 1)))
    return counts.BatchShape(levels, (3, 2)), nbr0, nbr1


def test_pairs_are_the_valid_entries_of_valid_rows():
    shape, _, _ = tiny_shape()
    assert [lv.pairs for lv in shape.levels] == [5, 1]


def test_conv_shapes_are_the_37_convs():
    shapes = counts.conv_shapes((32, 64, 96, 128, 160))
    assert sum(shapes.values()) == 37
    assert shapes[(0, 6, 32)] == 1 and shapes[(4, 160, 160)] == 4


def test_model_flops_by_hand():
    shape, _, _ = tiny_shape()
    planes, d, h, hidden, layers, ncls = (2, 4), 8, 2, 16, 1, 3
    # Subm convs: {(0,6,2):1, (0,2,2):7, (0,4,2):1, (1,4,4):4} at pairs 5 / 5 / 5 / 1.
    subm = 2 * (5 * 6 * 2 * 1 + 5 * 2 * 2 * 7 + 5 * 4 * 2 * 1 + 1 * 4 * 4 * 4)
    dense = 2 * 3 * 2 * 4 * 2 + 2 * 3 * 2 * 2 * 2  # strided + inverse (3 fine rows), 1x1 branch
    q, pairs = 5, 3 * 3 + 2 * 2
    proj = 2 * q * (2 * 8 + 8 * 8)
    layer = 2 * q * 4 * 64 + 2 * 2 * pairs * 4 * 2 + 2 * q * 2 * 8 * 16
    heads = 2 * 2 * q * (64 + 8 * 3 + 8 * 8)
    fwd = subm + dense + proj + layer + heads
    assert counts.model_flops(shape, planes, d, h, hidden, layers, ncls, False) == fwd
    input_conv = 2 * 5 * 6 * 2
    assert counts.model_flops(shape, planes, d, h, hidden, layers, ncls, True) == 3 * fwd - input_conv


def test_conv_bound_by_hand():
    shape, _, _ = tiny_shape()
    planes = (2, 4)
    want = 0.0
    for (lvl, cin, cout), calls in {(0, 6, 2): 1, (0, 2, 2): 7, (0, 4, 2): 1,
                                    (1, 4, 4): 4}.items():
        lv = shape.levels[lvl]
        nbytes = lv.n_valid * 27 * 4 + lv.n_valid * cin * 2 + 27 * cin * cout * 2 + lv.capacity * cout * 4
        want += calls * max(nbytes / counts.HBM_BYTES_PER_S, 2 * lv.pairs * cin * cout / counts.BF16_FLOPS)
    assert counts.conv_bound_s(shape, planes, False) == pytest.approx(want, rel=1e-12)


def test_attention_bound_by_hand():
    shape, _, _ = tiny_shape()
    slots, heads = 4, 2
    pairs = (9 + 4) * heads
    nbytes = 4 * 2 * heads * slots * 32 * 2 + 2 * slots * 4
    sfu = counts.SMS * counts.SFU_EXP_PER_CLOCK * counts.SM_CLOCK_HZ
    want = max(nbytes / counts.HBM_BYTES_PER_S, 2 * 2 * pairs * 32 / counts.BF16_FLOPS, pairs / sfu)
    assert counts.attn_bound_s(shape, slots, heads, 1, False) == pytest.approx(want, rel=1e-12)


def test_readers_share_and_roofline_from_a_record():
    shape, _, _ = tiny_shape()
    dims = dict(planes=(2, 4), d_model=8, num_heads=2, hidden=16, num_layers=1, n_classes=3)
    bound = counts.conv_bound_s(shape, dims["planes"], False)
    record = dict(trace={"busy_s": 0.5, "window_s": 2.0,
                         "kernel_s": {"void subm_conv_mma_kernel<32, 0>(...)": 4 * bound,
                                      "other": 1.0}},
                  traced_shapes=[(shape, 4)], train=False, dims=dims)
    assert readers.idle_share(record) == pytest.approx(75.0)
    assert readers.roofline(record, "conv") == pytest.approx(25.0)
    assert readers.roofline(record, "attn") is None  # no attention kernel ran
    flops = counts.model_flops(shape, dims["planes"], 8, 2, 16, 1, 3, False)
    assert readers.mfu(record) == pytest.approx(100 * flops / (2.0 * counts.BF16_FLOPS))
