"""The port's offline data preparation against the JAX package's, on the
synthetic inputs that ``tests/test_{segmentator,create_data,prep_datasets,
prep_utils}.py`` build: the native segmentator's segments, its build into
``build/`` and its raise on a failed build, ``read_ply``, ``create_data``
(generic and raw-ScanNet exports), ``prep_datasets`` (MultiScan, 3RScan,
ScanNet++, the OBJ reader with its MTL texture lookup), ``remap_superpoints``,
``arkitscenes_utils`` and ``arkitscenes_loader`` (``FrameLoader``,
``accumulate_scene``, ``extract_gt_boxes``, ``prepare_arkitscenes`` with mesh
superpoints). Every written tree is equal to the JAX tool's byte for byte,
every returned array bit for bit, and every prepared dataset reads back
through the port's ``data/datasets.py::IndoorDataset``.

The JAX segmentator is built in a directory of this module's own (the
fixture ``private_jax_segmentator``), so that this file writes nothing under
``unidet3d_tpu/native/``, where the JAX package's own tests build it.
"""
import json
import os
import pickle
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from test_create_data import _write_binary_ply, _write_fake_scannet_scan
from test_prep_datasets import _grid_mesh
from unidet3d_tpu.native import segmentator as jax_segmentator
from unidet3d_tpu.tools import arkitscenes_loader as jax_ark_loader
from unidet3d_tpu.tools import arkitscenes_utils as jax_ark_utils
from unidet3d_tpu.tools import create_data as jax_create_data
from unidet3d_tpu.tools import ply as jax_ply
from unidet3d_tpu.tools import prep_datasets as jax_prep
from unidet3d_tpu.tools import remap_superpoints as jax_remap
from unidet3d_tpu_torch.data.dataset_specs import DEFAULT_LABEL_MAPPINGS
from unidet3d_tpu_torch.data.datasets import IndoorDataset
from unidet3d_tpu_torch.data.pipelines import train_pipeline
from unidet3d_tpu_torch.native import segmentator
from unidet3d_tpu_torch.tools import (
    arkitscenes_loader,
    arkitscenes_utils,
    create_data,
    ply,
    prep_datasets,
    remap_superpoints,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def private_jax_segmentator(tmp_path_factory):
    """The JAX segmentator's library, built and loaded from a directory of
    this module's own for every test here. The JAX loader compiles in place
    into its package directory, first deleting every segmentator library it
    finds there, and remembers a failure for the rest of the process; so
    processes that load it there at once can break each other's load. Its
    module globals point it here instead, and the unchanged loader compiles
    the unchanged source into this directory and cleans up only here. It is
    loaded once on this thread before any test runs: the JAX tools call it
    from a thread pool, and a second thread that enters the loader while the
    first compiles is told the library is unavailable."""
    lib_dir = tmp_path_factory.mktemp("jax_segmentator")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_segmentator, "_DIR", str(lib_dir))
        mp.setattr(jax_segmentator, "_LIB",
                   str(lib_dir / os.path.basename(jax_segmentator._LIB)))
        mp.setattr(jax_segmentator, "_lib", None)
        mp.setattr(jax_segmentator, "_tried", False)
        assert jax_segmentator.available()
        assert os.listdir(lib_dir) == [os.path.basename(jax_segmentator._LIB)]
        yield lib_dir


def _grid_plane(nx, ny, z_fn, x0=0.0):
    """Triangulated grid plane (verts, faces): ``tests/test_segmentator.py``'s
    mesh, copied because importing that module loads the JAX library in its
    package directory."""
    xs, ys = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    verts = np.stack(
        [x0 + xs.ravel().astype(np.float32), ys.ravel().astype(np.float32),
         z_fn(xs.ravel(), ys.ravel()).astype(np.float32)], 1)
    faces = []
    for i in range(nx - 1):
        for j in range(ny - 1):
            a = i * ny + j
            b = (i + 1) * ny + j
            faces.append([a, b, a + 1])
            faces.append([b, b + 1, a + 1])
    return verts, np.asarray(faces, np.int32)


def assert_trees_equal(mine, ref):
    """The same relative file names under both roots, each file equal byte
    for byte."""
    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    names = files(ref)
    assert files(mine) == names and names
    for name in names:
        with open(os.path.join(mine, name), "rb") as a, open(os.path.join(ref, name), "rb") as b:
            assert a.read() == b.read(), name


def assert_arrays_equal(mine, ref):
    if isinstance(ref, dict):
        assert mine.keys() == ref.keys()
        for k in ref:
            assert_arrays_equal(mine[k], ref[k])
    elif isinstance(ref, (tuple, list)):
        assert len(mine) == len(ref)
        for a, b in zip(mine, ref):
            assert_arrays_equal(a, b)
    elif isinstance(ref, np.ndarray):
        assert mine.dtype == ref.dtype and mine.shape == ref.shape
        np.testing.assert_array_equal(mine, ref)
    else:
        assert mine == ref


# ---------------------------------------------------------------- segmentator

def _meshes():
    rng = np.random.RandomState(0)
    tent = np.vectorize(lambda x, y: float(x) if x < 10 else 20.0 - x)
    noisy = _grid_mesh(30, rng)
    return {
        "flat": (*_grid_plane(12, 12, lambda x, y: np.zeros_like(x, float)), 0.01, 5),
        "tent": (*_grid_plane(21, 12, lambda x, y: tent(x, y)), 0.005, 5),
        "merge": (*_grid_plane(6, 6, lambda x, y: np.zeros_like(x, float)), 1e-6, 1000),
        "noisy": (*noisy, 0.01, 20),
        "noisy-fine": (*noisy, 0.001, 3),
    }


@pytest.mark.parametrize("mesh", sorted(_meshes()))
def test_segments_equal_jax(mesh):
    verts, faces, kthr, min_verts = _meshes()[mesh]
    assert jax_segmentator.available()
    mine = segmentator.segment_mesh(verts, faces, kthr=kthr, seg_min_verts=min_verts)
    ref = jax_segmentator.segment_mesh(verts, faces, kthr=kthr, seg_min_verts=min_verts)
    assert mine.dtype == np.int32
    np.testing.assert_array_equal(mine, ref)
    if mesh == "tent":
        assert mine.max() >= 1
    if mesh in ("flat", "merge"):
        assert mine.max() == 0


def test_segment_mesh_checks_its_input():
    verts, faces, _, _ = _meshes()["flat"]
    with pytest.raises(ValueError, match="outside"):
        segmentator.segment_mesh(verts, faces + len(verts))
    with pytest.raises(ValueError, match=r"\(V, 3\)"):
        segmentator.segment_mesh(verts[:, :2], faces)


def test_library_builds_into_build_dir_under_the_source_hash(tmp_path, monkeypatch):
    assert segmentator.library_path().parent == segmentator.Path(ROOT) / "build"
    assert segmentator.library_path().name.startswith("libunidet3d_segmentator-")
    monkeypatch.setattr(segmentator, "BUILD_DIR", tmp_path / "build")
    src = tmp_path / "segmentator.cc"
    src.write_bytes(segmentator.SRC.read_bytes())
    lib = segmentator.build(src)
    assert lib.parent == tmp_path / "build" and lib.exists()
    assert lib == segmentator.library_path(src)
    mtime = lib.stat().st_mtime_ns
    assert segmentator.build(src).stat().st_mtime_ns == mtime  # built once
    src.write_bytes(src.read_bytes() + b"\n// edited\n")
    assert segmentator.build(src) != lib


def test_compiler_error_raises_with_its_output(tmp_path, monkeypatch):
    monkeypatch.setattr(segmentator, "BUILD_DIR", tmp_path / "build")
    src = tmp_path / "broken.cc"
    src.write_text(segmentator.SRC.read_text().replace("int32_t next = 0;", "int32_t next = ;"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for broken.cc:\n(.|\n)*error"):
        segmentator.build(src)
    assert not list((tmp_path / "build").glob("*.so"))


_NO_GXX = """
import sys
from pathlib import Path
import numpy as np
from unidet3d_tpu_torch.native import segmentator
segmentator.BUILD_DIR = Path(sys.argv[1])
try:
    segmentator.segment_mesh(np.zeros((3, 3), np.float32), np.array([[0, 1, 2]]))
except RuntimeError as e:
    assert "g++ not found" in str(e), e
    print("raised")
"""


def test_missing_compiler_raises(tmp_path):
    res = subprocess.run([sys.executable, "-c", _NO_GXX, str(tmp_path / "empty_build")],
                         cwd=ROOT, env={**os.environ, "PATH": ""}, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["raised"]


# ----------------------------------------------------------------------- PLY

def _write_ascii_ply(path, verts, colors, faces):
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\ncomment synthetic\n"
                f"element vertex {len(verts)}\n"
                "property float x\nproperty float y\nproperty float z\n"
                "property uchar red\nproperty uchar green\nproperty uchar blue\n"
                f"element face {len(faces)}\nproperty list uchar int vertex_indices\n"
                "end_header\n")
        for v, c in zip(verts, colors):
            f.write(f"{v[0]} {v[1]} {v[2]} {c[0]} {c[1]} {c[2]}\n")
        for face in faces:
            f.write(f"3 {face[0]} {face[1]} {face[2]}\n")


@pytest.mark.parametrize("writer", [_write_binary_ply, _write_ascii_ply])
def test_read_ply_equals_jax(tmp_path, writer):
    rng = np.random.RandomState(1)
    verts = rng.rand(40, 3).astype(np.float32)
    colors = rng.randint(0, 255, (40, 3)).astype(np.uint8)
    faces = rng.randint(0, 40, (30, 3)).astype(np.int32)
    path = str(tmp_path / "mesh.ply")
    writer(path, verts, colors, faces)
    mine, ref = ply.read_ply(path), jax_ply.read_ply(path)
    assert_arrays_equal(mine, ref)
    np.testing.assert_array_equal(mine[1], faces)
    assert_arrays_equal(ply.mesh_points_colors(mine[0]), jax_ply.mesh_points_colors(ref[0]))
    (tmp_path / "bad.ply").write_bytes(b"obj\n")
    with pytest.raises(ValueError, match="not a PLY file"):
        ply.read_ply(str(tmp_path / "bad.ply"))


# --------------------------------------------------------------- create_data

def test_generic_export_equals_jax_and_reads_back(tmp_path):
    raw = tmp_path / "raw"
    os.makedirs(raw)
    rng = np.random.RandomState(0)
    for name in ("sceneA", "sceneB", "sceneC"):
        n = 100
        np.save(raw / f"{name}_point.npy", rng.rand(n, 6).astype(np.float32))
        np.save(raw / f"{name}_sem_label.npy", rng.randint(0, 5, n))
        np.save(raw / f"{name}_ins_label.npy", rng.randint(-1, 3, n))
        if name != "sceneC":  # no superpoints, no boxes
            np.save(raw / f"{name}_sp.npy", rng.randint(0, 8, n))
            np.save(raw / f"{name}_bbox.npy", np.concatenate(
                [rng.rand(2, 6).astype(np.float32), np.array([[0.0], [1.0]])], 1))
    names = ["sceneA", "sceneB", "sceneC"]
    mine = create_data.prepare_generic(str(raw), str(tmp_path / "mine"), names, "infos.pkl",
                                       workers=2)
    jax_create_data.prepare_generic(str(raw), str(tmp_path / "ref"), names, "infos.pkl",
                                    workers=2)
    assert_trees_equal(str(tmp_path / "mine"), str(tmp_path / "ref"))
    ds = IndoorDataset(os.path.dirname(mine), "infos.pkl", 2, test_mode=True)
    assert len(ds) == 3
    s = ds[0]
    assert s["points"].shape == (100, 6) and s["gt_bboxes_3d"].shape == (2, 6)
    assert s["sp_pts_mask"].max() < 8 and "pts_instance_mask" in s
    with pytest.raises(FileNotFoundError, match="missing"):
        create_data.export_generic_scene(str(raw), "sceneZ")


def test_scannet_export_equals_jax_and_reads_back(tmp_path):
    scans = tmp_path / "scans"
    os.makedirs(scans)
    _write_fake_scannet_scan(scans, "scene0000_00", np.random.RandomState(3))
    _write_fake_scannet_scan(scans, "scene0001_00", np.random.RandomState(4))
    tsv = tmp_path / "labels.tsv"
    tsv.write_text("id\traw_category\tcategory\tcount\tnyu40id\n"
                   "1\twall\twall\t1\t1\n2\tchair\tchair\t1\t5\n3\ttable\ttable\t1\t7\n")
    assert create_data.read_label_mapping(str(tsv)) == jax_create_data.read_label_mapping(
        str(tsv))
    names = ["scene0000_00", "scene0001_00"]
    create_data.prepare_scannet(str(scans), str(tmp_path / "mine"), names, "infos.pkl",
                                str(tsv), workers=2)
    jax_create_data.prepare_scannet(str(scans), str(tmp_path / "ref"), names, "infos.pkl",
                                    str(tsv), workers=2)
    assert_trees_equal(str(tmp_path / "mine"), str(tmp_path / "ref"))

    raw = IndoorDataset(str(tmp_path / "mine"), "infos.pkl", 0, test_mode=True)[0]
    assert set(np.unique(raw["pts_semantic_mask"])) == {0, 1, 5, 7}
    assert sorted(raw["gt_labels_3d"].tolist()) == [2, 4]
    s = IndoorDataset(str(tmp_path / "mine"), "infos.pkl", 0, pipeline=train_pipeline("scannet"),
                      seed=0)[0]
    assert sorted(s["gt_labels_3d"].tolist()) == [2, 4]
    with pytest.raises(ValueError, match="label-map-file"):
        create_data.prepare_scannet(str(scans), str(tmp_path / "x"), names, "i.pkl", None)


def test_instance_boxes_equal_jax():
    rng = np.random.RandomState(5)
    xyz = rng.rand(200, 3).astype(np.float32)
    inst = rng.randint(0, 6, 200)
    inst_to_nyu = {0: 5, 1: 7, 2: 1, 3: 39, 5: 5}
    cats = (3, 4, 5, 6, 7, 39)
    assert_arrays_equal(create_data.instance_boxes(xyz, inst, inst_to_nyu, cats),
                        jax_create_data.instance_boxes(xyz, inst, inst_to_nyu, cats))


def test_create_data_cli(tmp_path):
    raw = tmp_path / "raw"
    os.makedirs(raw)
    np.save(raw / "s_point.npy", np.random.RandomState(0).rand(50, 6).astype(np.float32))
    (tmp_path / "scenes.txt").write_text("s\n")
    path = create_data.main(["generic", "--raw-dir", str(raw), "--out-root",
                             str(tmp_path / "out"), "--scenes-file", str(tmp_path / "scenes.txt"),
                             "--out-name", "infos_val.pkl", "--workers", "1"])
    assert path == str(tmp_path / "out" / "infos_val.pkl")
    assert IndoorDataset(str(tmp_path / "out"), "infos_val.pkl", 0,
                         test_mode=True)[0]["points"].shape == (50, 6)


# ------------------------------------------------------------- prep_datasets

def test_boxes_from_instance_ids_equal_jax():
    xyz = np.array([[0, 0, 0], [2, 2, 2], [5, 5, 5], [7, 5, 5], [9, 9, 9]], np.float32)
    inst = np.array([0, 0, 1, 1, -1])
    for labels in ({0: 7, 1: 9}, {0: 7}, {}):
        assert_arrays_equal(prep_datasets.boxes_from_instance_ids(xyz, inst, labels),
                            jax_prep.boxes_from_instance_ids(xyz, inst, labels))


def _obj_files(tmp_path):
    (tmp_path / "v.obj").write_text(
        "v 0 0 0 0.1 0.2 0.3\nv 1 0 0 0.4 0.5 0.6\nv 0 1 0\nv 1 1 0\n"
        "f 1 2 3\nf 1/1 2/2 3/3 4/4\n")
    img = np.zeros((4, 4, 3), np.uint8)
    img[:, :2] = [200, 10, 20]
    img[:, 2:] = [10, 200, 20]
    Image.fromarray(img).save(tmp_path / "atlas.png")
    (tmp_path / "m.mtl").write_text("newmtl mat0\nmap_Kd atlas.png\n")
    (tmp_path / "m.obj").write_text(
        "mtllib m.mtl\nv 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 1\n"
        "vt 0.0 0.5\nvt 0.9 0.5\nvt 1.3 0.1\n"
        "f 1/1 2/2 3/3\nf 2/2 3/3 4/3\n")
    (tmp_path / "t.mtl").write_text("map_Kd atlas.png\n")  # found by the OBJ's own name
    (tmp_path / "t.obj").write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nvt 0.9 0.5\nf 1/1 2/1 3/1\n")
    return ["v.obj", "m.obj", "t.obj"]


def test_read_obj_mesh_equals_jax(tmp_path):
    for name in _obj_files(tmp_path):
        mine = prep_datasets.read_obj_mesh(str(tmp_path / name))
        assert_arrays_equal(mine, jax_prep.read_obj_mesh(str(tmp_path / name)))
    pts, _ = prep_datasets.read_obj_mesh(str(tmp_path / "m.obj"))
    np.testing.assert_array_equal(pts[0, 3:], [200, 10, 20])  # from the atlas
    np.testing.assert_array_equal(pts[1, 3:], [10, 200, 20])


def _multiscan_pths(pth_dir):
    os.makedirs(pth_dir)
    for i, seed in enumerate((0, 1)):
        rng = np.random.RandomState(seed)
        xyz, faces = _grid_mesh(12, rng)
        n = len(xyz)
        sem = np.full(n, 2, np.int64)
        inst = np.full(n, -1, np.int64)
        sem[:30], inst[:30] = 5, 4
        sem[30:50], inst[30:50] = 17, 9
        sem[50:55], inst[50:55] = -1, 11
        sem[60:70], inst[60:70] = 1, 12  # stuff: never a box
        torch.save({"xyz": xyz, "rgb": rng.rand(n, 3).astype(np.float32) * 255,
                    "faces": faces, "instance_ids": inst, "sem_labels": sem,
                    "inst2obj": {4: "chair.1", 9: "bed.2"}}, pth_dir / f"scene{i}.pth")


def test_prepare_multiscan_equals_jax_and_reads_back(tmp_path):
    _multiscan_pths(tmp_path / "pths")
    out = str(tmp_path / "mine")
    prep_datasets.prepare_multiscan(str(tmp_path / "pths"), out, "infos.pkl", workers=2)
    jax_prep.prepare_multiscan(str(tmp_path / "pths"), str(tmp_path / "ref"), "infos.pkl",
                               workers=2)
    assert_trees_equal(out, str(tmp_path / "ref"))
    ds = IndoorDataset(out, "infos.pkl", 2, test_mode=True,
                       label_mapping=DEFAULT_LABEL_MAPPINGS["multiscan"])
    s = ds[0]
    assert len(ds) == 2 and sorted(s["gt_labels_3d"].tolist()) == [2, 14]
    assert s["points"].shape == (144, 6) and s["sp_pts_mask"].shape == (144,)


def _rscan_raw(tmp_path):
    rng = np.random.RandomState(1)
    scenes = []
    for j, (scene_id, mesh) in enumerate((("abc-123", "obj"), ("def-456", "ply"))):
        xyz, faces = _grid_mesh(10, rng)
        n = len(xyz)
        d = tmp_path / "raw" / scene_id
        os.makedirs(d)
        if mesh == "obj":
            with open(d / "mesh.refined.v2.obj", "w") as f:
                for v in xyz:
                    f.write(f"v {v[0]} {v[1]} {v[2]} 0.5 0.5 0.5\n")
                for fc in faces:
                    f.write(f"f {fc[0] + 1} {fc[1] + 1} {fc[2] + 1}\n")
        else:
            _write_binary_ply(str(d / "mesh.refined.v2.color.ply"), xyz,
                              rng.randint(0, 255, (n, 3)).astype(np.uint8), faces)
        with open(d / "mesh.refined.0.010000.segs.v2.json", "w") as f:
            json.dump({"segIndices": (np.arange(n) // 10).tolist()}, f)
        with open(d / "semseg.v2.json", "w") as f:
            json.dump({"segGroups": [{"label": "chair", "segments": [0, 1]},
                                     {"label": "bed", "segments": [2]},
                                     {"label": "unknown", "segments": [4]}]}, f)
        scenes.append(scene_id)
    rot = np.eye(4)
    rot[:3, 3] = [1.0, -2.0, 0.5]
    meta = [{"reference": "abc-123",
             "scans": [{"reference": "def-456", "transform": rot.T.reshape(-1).tolist()}]}]
    with open(tmp_path / "3RScan.json", "w") as f:
        json.dump(meta, f)
    (tmp_path / "labels.csv").write_text("title line\nGlobal,Label,,y\n1,chair,5,z\n2,bed,4,z\n")
    align = {"abc-123": np.diag([1.0, -1.0, 1.0, 1.0])}
    with open(tmp_path / "align.pkl", "wb") as f:
        pickle.dump(align, f)
    return scenes


def test_prepare_3rscan_equals_jax_and_reads_back(tmp_path):
    scenes = _rscan_raw(tmp_path)
    csv_path = str(tmp_path / "labels.csv")
    assert prep_datasets.read_3rscan_label_map(csv_path) == jax_prep.read_3rscan_label_map(
        csv_path) == {"chair": 5, "bed": 4}
    assert_arrays_equal(prep_datasets.read_3rscan_transforms(str(tmp_path / "3RScan.json")),
                        jax_prep.read_3rscan_transforms(str(tmp_path / "3RScan.json")))
    args = (scenes, str(tmp_path / "3RScan.json"), csv_path, str(tmp_path / "align.pkl"))
    out = str(tmp_path / "mine")
    prep_datasets.prepare_3rscan(str(tmp_path / "raw"), out, *args, filename="infos.pkl",
                                 workers=2)
    jax_prep.prepare_3rscan(str(tmp_path / "raw"), str(tmp_path / "ref"), *args,
                            filename="infos.pkl", workers=2)
    assert_trees_equal(out, str(tmp_path / "ref"))
    ds = IndoorDataset(out, "infos.pkl", 3, test_mode=True,
                       label_mapping=DEFAULT_LABEL_MAPPINGS["3rscan"])
    for i in range(2):
        assert sorted(ds[i]["gt_labels_3d"].tolist()) == [1, 2]
        assert ds[i]["sp_pts_mask"].max() + 1 == 10


def _scannetpp_raw(tmp_path):
    rng = np.random.RandomState(2)
    xyz, faces = _grid_mesh(10, rng)
    n = len(xyz)
    scans = tmp_path / "raw" / "data" / "spp0" / "scans"
    os.makedirs(scans)
    _write_binary_ply(str(scans / "mesh_aligned_0.05.ply"), xyz,
                      rng.randint(0, 255, (n, 3)).astype(np.uint8), faces)
    with open(scans / "segments_anno.json", "w") as f:
        json.dump({"segGroups": [
            {"label": "office chair", "segments": list(range(0, 25))},
            {"label": "table", "segments": list(range(25, 50))},
            {"label": "unknown junk", "segments": list(range(50, 60))},
            {"label": "wall", "segments": list(range(95, 200))},  # ids past n dropped
        ]}, f)
    meta = tmp_path / "raw" / "metadata" / "semantic_benchmark"
    os.makedirs(meta)
    (meta / "top100.txt").write_text("wall\nfloor\ntable\nchair\n")
    (meta / "map_benchmark.csv").write_text(
        "class,semantic_map_to,instance_map_to\noffice chair,chair,chair\n")
    return str(meta)


def test_prepare_scannetpp_equals_jax_and_reads_back(tmp_path):
    meta = _scannetpp_raw(tmp_path)
    assert prep_datasets.read_scannetpp_label_maps(meta) == jax_prep.read_scannetpp_label_maps(
        meta)
    out = str(tmp_path / "mine")
    prep_datasets.prepare_scannetpp(str(tmp_path / "raw"), out, ["spp0"], filename="infos.pkl",
                                    workers=1)
    jax_prep.prepare_scannetpp(str(tmp_path / "raw"), str(tmp_path / "ref"), ["spp0"],
                               filename="infos.pkl", workers=1)
    assert_trees_equal(out, str(tmp_path / "ref"))
    s = IndoorDataset(out, "infos.pkl", 4, test_mode=True)[0]
    assert sorted(s["gt_labels_3d"].tolist()) == [0, 2, 3]
    assert set(np.unique(s["pts_semantic_mask"])) == {-1, 0, 2, 3}


# ------------------------------------------------- remap_superpoints, ARKitScenes

def test_remap_superpoints_equals_jax(tmp_path):
    rng = np.random.RandomState(0)
    pts = np.concatenate([rng.rand(60, 3).astype(np.float32),
                          np.zeros((60, 3), np.float32)], 1)
    perm = rng.permutation(60)
    sp_pts = pts[perm][:50]  # 10 points without a match
    sp = (perm[:50] % 7).astype(np.int64)
    mine = remap_superpoints.remap_superpoints(pts, sp_pts, sp)
    assert_arrays_equal(mine, jax_remap.remap_superpoints(pts, sp_pts, sp))
    for name, arr in (("p", pts), ("s", sp_pts)):
        arr.tofile(tmp_path / f"{name}.bin")
    sp.tofile(tmp_path / "sp.bin")
    out = remap_superpoints.main([str(tmp_path / "p.bin"), str(tmp_path / "s.bin"),
                                  str(tmp_path / "sp.bin"), str(tmp_path / "o.bin")])
    np.testing.assert_array_equal(np.fromfile(tmp_path / "o.bin", np.int64), mine)
    np.testing.assert_array_equal(out, mine)


def test_arkitscenes_utils_equal_jax():
    rng = np.random.RandomState(4)
    depth = rng.uniform(0, 12, (6, 8)).astype(np.float32)  # some beyond max_depth
    depth[0, :3] = 0
    k = np.array([[30.0, 0, 4.0], [0, 30.0, 3.0], [0, 0, 1]])
    pose = np.eye(4)
    pose[:3, :3] = jax_ark_loader.angle_axis_to_matrix([0.1, -0.2, 0.3])
    pose[:3, 3] = [1, 2, 3]
    rgb = rng.rand(6, 8, 3)
    for args in ((depth, k, pose), (depth, k, pose, rgb)):
        assert_arrays_equal(arkitscenes_utils.unproject_depth(*args),
                            jax_ark_utils.unproject_depth(*args))
    pts = (rng.rand(300, 6) * [1, 1, 1, 255, 255, 255]).astype(np.float32)
    assert_arrays_equal(arkitscenes_utils.voxel_downsample(pts, 0.1),
                        jax_ark_utils.voxel_downsample(pts, 0.1))
    frames = [(depth, k, pose, rgb), (depth[::-1].copy(), k, np.eye(4), rgb)]
    assert_arrays_equal(arkitscenes_utils.accumulate_frames(frames, 0.2),
                        jax_ark_utils.accumulate_frames(frames, 0.2))
    rot = pose[:3, :3]
    assert_arrays_equal(arkitscenes_utils.annotation_to_box7([1, 2, 3], [2, 1, 1], rot),
                        jax_ark_utils.annotation_to_box7([1, 2, 3], [2, 1, 1], rot))
    ann = {"data": [{"label": "chair", "segments": {"obbAligned": {
        "centroid": [1, 2, 3], "axesLengths": [1, 2, 1],
        "normalizedAxes": rot.reshape(-1).tolist()}}}]}
    assert_arrays_equal(arkitscenes_utils.boxes_from_annotation_json(ann),
                        jax_ark_utils.boxes_from_annotation_json(ann))
    assert_arrays_equal(arkitscenes_utils.boxes_from_annotation_json({}),
                        jax_ark_utils.boxes_from_annotation_json({}))


def _arkit_raw(split_dir, rng):
    """Two ARKitScenes 3DOD scenes (frames, annotations, a mesh) and a
    skipped one."""
    h, w = 24, 32
    for j, vid in enumerate(("41069021", "41069022", "41069023")):
        d = split_dir / vid
        frames = d / f"{vid}_frames"
        for sub in ("lowres_depth", "lowres_wide", "lowres_wide_intrinsics"):
            os.makedirs(frames / sub)
        for fid in ("1.001", "1.101"):
            depth = rng.randint(1500, 2500, (h, w)).astype(np.uint16)
            Image.fromarray(depth).save(frames / "lowres_depth" / f"{vid}_{fid}.png")
            Image.fromarray(rng.randint(0, 255, (h // 2, w // 2, 3)).astype(np.uint8)).save(
                frames / "lowres_wide" / f"{vid}_{fid}.png")  # resized to the depth's size
        k = f"{w} {h} 20.0 20.0 {w / 2} {h / 2}"
        (frames / "lowres_wide_intrinsics" / f"{vid}_1.001.pincam").write_text(k)
        (frames / "lowres_wide_intrinsics" / f"{vid}_1.102.pincam").write_text(k)
        with open(frames / "lowres_wide.traj", "w") as f:
            f.write("1.001 0.1 0 0 0 0 0\n1.103 0 0.2 0 0.1 0 0\n")
        rot = jax_ark_loader.angle_axis_to_matrix([0, 0, 0.4 * (j + 1)])
        ann = {"skipped": j == 2, "data": [
            {"label": "tv monitor", "segments": {"obbAligned": {
                "centroid": [0.1, 0.2, 2.0], "axesLengths": [0.5, 0.5, 0.5],
                "normalizedAxes": rot.reshape(-1).tolist()}}},
            {"label": "unknowncat", "segments": {"obbAligned": {
                "centroid": [0, 0, 0], "axesLengths": [1, 1, 1],
                "normalizedAxes": list(np.eye(3).reshape(-1))}}},
            {"label": "chair", "segments": {"obbAligned": {
                "centroid": [-0.3, 0, 2.2], "axesLengths": [0.4, 0.6, 0.8],
                "normalizedAxes": list(np.eye(3).reshape(-1))}}}]}
        with open(d / f"{vid}_3dod_annotation.json", "w") as f:
            json.dump(ann, f)
        if j == 0:  # a mesh over the frames' footprint: superpoints
            xyz, faces = _grid_mesh(16, rng, scale=2.0)
            xyz = xyz - [1.0, 1.0, -2.0]
            _write_binary_ply(str(d / f"{vid}_3dod_mesh.ply"), xyz,
                              rng.randint(0, 255, (len(xyz), 3)).astype(np.uint8), faces)


def test_arkitscenes_loader_equals_jax_and_reads_back(tmp_path):
    split = tmp_path / "3dod" / "Training"
    _arkit_raw(split, np.random.RandomState(6))
    assert_arrays_equal(arkitscenes_loader.parse_traj_line("1.001 0.1 0.2 0 1.0 2.0 3.0"),
                        jax_ark_loader.parse_traj_line("1.001 0.1 0.2 0 1.0 2.0 3.0"))
    with pytest.raises(ValueError, match="bad traj line"):
        arkitscenes_loader.parse_traj_line("1.0 0 0")
    frames = str(split / "41069021" / "41069021_frames")
    mine, ref = arkitscenes_loader.FrameLoader(frames), jax_ark_loader.FrameLoader(frames)
    assert len(mine) == len(ref) == 2 and mine.video_id == ref.video_id
    for i in range(2):
        assert_arrays_equal(mine[i], ref[i])
    assert_arrays_equal(arkitscenes_loader.accumulate_scene(mine, 0.1),
                        jax_ark_loader.accumulate_scene(ref, 0.1))
    ann = str(split / "41069021" / "41069021_3dod_annotation.json")
    boxes, labels, skipped = arkitscenes_loader.extract_gt_boxes(ann)
    assert_arrays_equal((boxes, labels, skipped), jax_ark_loader.extract_gt_boxes(ann))
    assert labels.tolist() == [15, 13] and not skipped

    out = str(tmp_path / "mine")
    arkitscenes_loader.prepare_arkitscenes(str(tmp_path / "3dod"), out, workers=2)
    jax_ark_loader.prepare_arkitscenes(str(tmp_path / "3dod"), str(tmp_path / "ref"), workers=2)
    assert_trees_equal(out, str(tmp_path / "ref"))
    ds = IndoorDataset(out, "arkitscenes_infos_train.pkl", 5, test_mode=True)
    assert len(ds) == 2  # the skipped scene left out
    s = ds[0]
    assert s["gt_bboxes_3d"].shape == (2, 7) and sorted(s["gt_labels_3d"].tolist()) == [13, 15]
    assert s["sp_pts_mask"].shape == (len(s["points"]),)
    assert os.listdir(os.path.join(out, "super_points")) == ["41069021.bin"]
