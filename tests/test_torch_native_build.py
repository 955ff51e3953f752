"""First builds of the port's libraries started at once from many threads:
``native/build.py::build_library`` (g++, the rulebook and segmentator
libraries) and ``ops/cuda_build.py::build`` (nvcc, here a stand-in script
that writes its output slowly), and a 4-worker ``TrainLoader`` whose
workers all reach the rulebook library's first build on a fresh build
directory. Every call returns the same library, it loads, and no temporary
file is left behind."""
import ctypes
import os
import stat
import sys
import threading

import numpy as np

from tests.test_torch_train_loop import MULTISCAN, TINY, scene
from unidet3d_tpu_torch.core.config import default_config
from unidet3d_tpu_torch.data.datasets import ConcatDataset, IndoorDataset
from unidet3d_tpu_torch.data.dataset_specs import DEFAULT_LABEL_MAPPINGS
from unidet3d_tpu_torch.data.loader import TrainLoader
from unidet3d_tpu_torch.data.pipelines import train_pipeline
from unidet3d_tpu_torch.data.synthetic import write_info_dataset
from unidet3d_tpu_torch.native import build as native_build
from unidet3d_tpu_torch.native import rulebook
from unidet3d_tpu_torch.ops import cuda_build

THREADS = 8
ROUNDS = 5


def run_at_once(fn, n=THREADS):
    """`fn()` on n threads released together: [result or exception]."""
    barrier = threading.Barrier(n)
    out = [None] * n

    def body(i):
        barrier.wait()
        try:
            out[i] = fn()
        except BaseException as e:  # noqa: BLE001 - reported by the caller
            out[i] = e

    threads = [threading.Thread(target=body, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def test_concurrent_first_builds_return_one_loadable_library(tmp_path):
    for r in range(ROUNDS):
        build_dir = tmp_path / f"round{r}"
        paths = run_at_once(lambda: native_build.build_library(
            rulebook.SRC, rulebook.STEM, rulebook.CXX_FLAGS, build_dir))
        lib = native_build.library_path(rulebook.SRC, rulebook.STEM, rulebook.CXX_FLAGS,
                                        build_dir)
        assert paths == [lib] * THREADS, paths
        assert ctypes.CDLL(str(lib)).unidet3d_build_gridpack
        assert sorted(p.name for p in build_dir.iterdir()) == [lib.name]


FAKE_NVCC = """#!{python}
import sys, time
args = sys.argv[1:]
out = args[args.index("-o") + 1]
with open({log!r}, "a") as f:
    f.write(out + "\\n")
with open(out, "wb") as f:  # written in parts, slowly: a reader would see it partial
    for _ in range(5):
        f.write(b"x" * 1000)
        f.flush()
        time.sleep(0.05)
print("ptxas info    : Used 32 registers")
"""


def test_concurrent_kernel_builds_run_nvcc_once_per_source(tmp_path, monkeypatch):
    bin_dir, log = tmp_path / "bin", tmp_path / "nvcc.log"
    bin_dir.mkdir()
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable, log=str(log)))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    names = ("attention", "subm_conv")
    reports = run_at_once(lambda: cuda_build.build(names))
    assert not [r for r in reports if isinstance(r, BaseException)], reports
    built = [r for r in reports if r]
    assert len(built) == 1 and sorted(built[0]) == sorted(names), reports
    assert all("Used 32 registers" in text for text in built[0].values())
    libs = sorted(cuda_build.library_path(n).name for n in names)
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == libs
    assert all((tmp_path / "build" / n).stat().st_size == 5000 for n in libs)
    assert len(log.read_text().split()) == len(names)  # one nvcc per source
    assert cuda_build.build(names) == {}  # built: nothing to do


def test_train_loader_workers_share_the_first_build(tmp_path, monkeypatch):
    root = str(tmp_path / "multiscan")
    write_info_dataset(root, [scene(MULTISCAN, f"s{i}", n, 7 + i)
                              for i, n in enumerate((1500, 1800, 1600))])
    data = ConcatDataset([IndoorDataset(
        root, "infos.pkl", MULTISCAN, pipeline=train_pipeline("multiscan"),
        label_mapping=DEFAULT_LABEL_MAPPINGS["multiscan"], seed=MULTISCAN)])
    monkeypatch.setattr(rulebook, "BUILD_DIR", tmp_path / "build")
    rulebook.load.cache_clear()
    loader = TrainLoader(data, default_config(**TINY), 2, seed=0, num_threads=4,
                         device="cpu")
    try:
        batches = [next(loader) for _ in range(6)]
    finally:
        loader.close()
        rulebook.load.cache_clear()
    for tb in batches:
        assert tb.pack.n_valid[0] > 0
        assert np.asarray(tb.host[0].valid).sum() > 0
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == [
        rulebook.library_path().name]
