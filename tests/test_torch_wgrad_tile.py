"""The host side of K2, the conv weight gradient's kernel: its block shape
(``wgrad_tile``) and row splits (``wgrad_plan``) at the ten (level, Cin,
Cout) shapes of the production training step, and the tile chooser's list of
instances against the kernel source's. The kernel itself runs only on the
card (``tests/test_torch_cuda.py``); its plain version's parity with the
JAX package's VJP is in ``tests/test_torch_train_ops.py``.
"""
import re

import pytest
import torch

from unidet3d_tpu_torch.ops import cuda_build
from unidet3d_tpu_torch.ops.subm_conv_cuda import (
    WGRAD_INSTANCES,
    wgrad_plan,
    wgrad_smem,
    wgrad_tile,
)

SMEM_LIMIT = 232448  # shared memory one block can use on the H100 (227 KB)
ACC_BUDGET = 96  # fp32 accumulators a thread may keep
# (Cin, Cout, valid voxels of the level) of the step's convs: the 8-scene
# training batch's levels 0-4 at the default planes 32..160.
TRAIN_SHAPES = [(6, 32, 689706), (32, 32, 689706), (64, 32, 689706), (64, 64, 307357),
                (128, 64, 307357), (96, 96, 81501), (192, 96, 81501), (128, 128, 19648),
                (256, 128, 19648), (160, 160, 4596)]


@pytest.mark.parametrize("cin,cout,n_valid", TRAIN_SHAPES)
def test_wgrad_tile_covers_the_shape_within_the_budget(cin, cout, n_valid):
    tile, splits, scratch = wgrad_plan(n_valid, cin, cout, torch.bfloat16)
    assert tile == wgrad_tile(cin, cout)
    # Channel tiles are multiples of 16 that cover Cin and Cout without
    # padding past the next multiple of 16 (96 and 160 stay 96 and 160).
    tiles_c, tiles_d = -(-cin // tile.cin_tile), -(-cout // tile.cout_tile)
    assert tile.cin_tile % 16 == 0 and tile.cout_tile % 16 == 0
    assert tiles_c * tile.cin_tile <= 16 * -(-cin // 16)
    assert tiles_d * tile.cout_tile <= 16 * -(-cout // 16)
    # The 27 offsets in groups of equal size (the last one smaller).
    groups = -(-27 // tile.group)
    assert groups * tile.group - 27 < groups
    assert tile.blocks == groups * tiles_c * tiles_d
    # A compiled instance: each of 4 warps keeps the offsets of one parity
    # and half the Cout tile, ceil(group / 2) x MT x NT x 4 accumulators,
    # within the budget.
    mt, nt = tile.cin_tile // 16, tile.cout_tile // 16
    (gw,) = [g for m, n, g in WGRAD_INSTANCES if (m, n) == (mt, nt)]
    assert tile.group <= 2 * gw
    assert tile.acc == -(-tile.group // 2) * mt * nt * 4 <= ACC_BUDGET
    assert tile.smem == wgrad_smem(mt, nt, gw) <= SMEM_LIMIT // 2  # 2 blocks per SM
    assert tile.rows == 32
    # Splits: at least 256 rows each, and the partial scratch the wrapper
    # allocates holds one fp32 dW per split (none for one split).
    assert 1 <= splits <= max(1, -(-n_valid // 32) // 8)
    assert scratch == ((splits if splits > 1 else 0), 27, cin, cout)
    assert splits * tile.blocks <= 8 * 132 + tile.blocks


def test_wgrad_tile_fp32_route_keeps_its_grid():
    """The fp32 FMA route: 32 x 32 or 64 x 64 tiles, one offset per block,
    64-row tiles, and the first version's row splits."""
    assert wgrad_tile(32, 64, torch.float32)[:3] == (32, 32, 1)
    assert wgrad_tile(64, 64, torch.float32)[:3] == (64, 64, 1)
    tile, splits, scratch = wgrad_plan(2711, 96, 96, torch.float32)
    assert (tile.blocks, tile.rows, tile.smem) == (27 * 4, 64, 0)
    assert splits == -(-2711 // 64) // 4 and scratch == (splits, 27, 96, 96)
    assert wgrad_plan(100, 32, 32, torch.float32)[1:] == (1, (0, 27, 32, 32))
    with pytest.raises(ValueError):
        wgrad_tile(32, 32, torch.float16)


def test_wgrad_instances_are_the_kernels():
    """The host's instance list is the kernel source's K2_INSTANCES, and
    every tile the chooser can return for a width of 1-320 is one of them."""
    src = (cuda_build.CSRC / "subm_conv_wgrad.cu").read_text()
    block = src[src.index("#define K2_INSTANCES(X)"):]
    block = block[:block.index("\n\n")]
    compiled = tuple(tuple(int(x) for x in m)
                     for m in re.findall(r"X\((\d+), (\d+), (\d+)\)", block))
    assert compiled == WGRAD_INSTANCES
    shapes = {(16 * m, 16 * n) for m, n, _ in WGRAD_INSTANCES}
    for cin in (1, 3, 6, 8, 40, 96, 130, 320):
        for cout in (2, 16, 32, 48, 96, 160, 250):
            tile = wgrad_tile(cin, cout)
            assert (tile.cin_tile, tile.cout_tile) in shapes
            assert tile.acc <= ACC_BUDGET
