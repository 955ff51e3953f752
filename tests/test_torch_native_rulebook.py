"""The port's native GridPack builder (``unidet3d_tpu_torch/native/rulebook.cc``
through ``native/rulebook.py``) against the port's numpy builder and the JAX
package's numpy builder, on every array and every row, padding rows included;
and its build: into ``build/`` under a hash of the source and flags, again
when the source changes, and a raise (no fallback) without g++."""
import os
import subprocess
import sys

import numpy as np
import pytest

from unidet3d_tpu.ops.gridpack import build_gridpack_numpy as jax_build_numpy
from unidet3d_tpu_torch.native import rulebook
from unidet3d_tpu_torch.ops.gridpack import build_gridpack_host, build_gridpack_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def random_points(seed, n, n_scenes, extent):
    rng = np.random.RandomState(seed)
    bxyz = np.concatenate([rng.randint(0, n_scenes, (n, 1)),
                           rng.randint(0, extent, (n, 3))], 1).astype(np.int32)
    return bxyz, rng.rand(n) > 0.05


def assert_same_pack(mine, mine_counts, ref, ref_counts, n_valid=True):
    np.testing.assert_array_equal(mine.point_inverse, np.asarray(ref.point_inverse))
    np.testing.assert_array_equal(mine_counts, ref_counts)
    for name in ("valid", "neighbors", "parent", "offset_code"):
        a, b = getattr(mine, name), getattr(ref, name)
        assert len(a) == len(b), name
        for lvl, (x, y) in enumerate(zip(a, b)):
            y = np.asarray(y)
            assert x.dtype == y.dtype and x.shape == y.shape, (name, lvl)
            np.testing.assert_array_equal(x, y, err_msg=f"{name} level {lvl}")
    if n_valid:
        assert mine.n_valid == ref.n_valid
        assert mine.n_valid == tuple(int(v.sum()) for v in mine.valid)


CASES = {
    # name: (seed, points, scenes, extent, capacities)
    "random": (0, 5000, 1, 40, [8192, 4096, 2048, 1024, 512]),
    "dense": (1, 20000, 1, 24, [16384, 8192, 4096, 2048, 1024]),
    "overflow": (2, 5000, 1, 64, [1024, 256, 64]),
    "two_scenes": (3, 6000, 2, 48, [8192, 4096, 2048, 1024]),
    "one_level": (4, 3000, 1, 30, [4096]),
    "far_coords": (5, 4000, 3, 4200, [8192, 4096, 2048]),  # clipped to 4095
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("threads", [1, 4])
def test_native_equals_numpy_builders_on_every_row(case, threads):
    seed, n, scenes, extent, caps = CASES[case]
    bxyz, valid = random_points(seed, n, scenes, extent)
    mine, mine_counts = build_gridpack_host(bxyz, valid, caps, num_threads=threads)
    ref, ref_counts = build_gridpack_numpy(bxyz, valid, caps)
    assert_same_pack(mine, mine_counts, ref, ref_counts)
    jax_ref, jax_counts = jax_build_numpy(bxyz, valid, caps)
    assert_same_pack(mine, mine_counts, jax_ref, jax_counts, n_valid=False)


def test_native_all_invalid_equals_numpy():
    bxyz, _ = random_points(6, 500, 1, 32)
    valid = np.zeros(500, bool)
    mine, mine_counts = build_gridpack_host(bxyz, valid, [64, 32])
    ref, ref_counts = build_gridpack_numpy(bxyz, valid, [64, 32])
    assert_same_pack(mine, mine_counts, ref, ref_counts)
    assert mine.n_valid == (0, 0) and (mine.point_inverse == 64).all()


def test_native_rejects_malformed_input():
    bxyz, valid = random_points(7, 100, 1, 8)
    with pytest.raises(ValueError):
        rulebook.build_gridpack(bxyz[:, :3], valid, [128])
    with pytest.raises(ValueError):
        rulebook.build_gridpack(bxyz, valid[:50], [128])
    with pytest.raises(ValueError):
        rulebook.build_gridpack(bxyz, valid, [128, 0])


def test_library_builds_into_build_dir_under_the_source_hash(tmp_path, monkeypatch):
    # The repository's library lives in <repo>/build.
    assert rulebook.library_path().parent == rulebook.Path(ROOT) / "build"
    monkeypatch.setattr(rulebook, "BUILD_DIR", tmp_path / "build")
    src = tmp_path / "rulebook.cc"
    src.write_bytes(rulebook.SRC.read_bytes())
    lib = rulebook.build(src)
    assert lib.parent == tmp_path / "build" and lib.exists()
    assert lib == rulebook.library_path(src)
    assert rulebook.build(src) == lib  # built once
    mtime = lib.stat().st_mtime_ns
    assert rulebook.build(src).stat().st_mtime_ns == mtime

    src.write_bytes(src.read_bytes() + b"\n// edited\n")
    rebuilt = rulebook.build(src)
    assert rebuilt != lib and rebuilt.exists() and lib.exists()


_NO_GXX = """
import sys
from pathlib import Path
import numpy as np
from unidet3d_tpu_torch.native import rulebook
from unidet3d_tpu_torch.data.batcher import collate
from unidet3d_tpu_torch.core.config import default_config
rulebook.BUILD_DIR = Path(sys.argv[1])
for call in (
    lambda: rulebook.build_gridpack(np.zeros((4, 4), np.int32), np.ones(4, bool), [8]),
    lambda: collate([{"points": np.random.rand(100, 6).astype(np.float32),
                      "dataset_idx": 0}],
                    default_config(max_points=128, voxel_capacity=128)),
):
    try:
        call()
    except RuntimeError as e:
        assert "g++ not found" in str(e), e
        print("raised")
    else:
        print("no error")
"""


def test_missing_compiler_raises_without_fallback(tmp_path):
    res = subprocess.run([sys.executable, "-c", _NO_GXX, str(tmp_path / "empty_build")],
                         cwd=ROOT, env={**os.environ, "PATH": ""}, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["raised", "raised"]


def test_compiler_error_carries_its_output(tmp_path, monkeypatch):
    monkeypatch.setattr(rulebook, "BUILD_DIR", tmp_path / "build")
    src = tmp_path / "broken.cc"
    src.write_text("this is not C++;\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for broken.cc:\n.*error"):
        rulebook.build(src)
    assert not list((tmp_path / "build").glob("*.so"))
