"""The port's visualisation (``unidet3d_tpu_torch/viz``) against the JAX
package's ``viz`` on the same seeded numpy inputs: the ``.obj`` text of
``show_result``, ``show_seg_result`` and the images of
``show_multi_modality_result`` and every ``image_vis`` drawing.

Box corners: the two packages compute them with their own cos / sin, which
differ in the last bit for a nonzero yaw (XLA's and PyTorch's float32
``cos`` are not the same function). So the text of a yaw-0 box is equal byte
for byte, and a yawed box's vertex coordinates are held within 1e-6 (a few
float32 ulps at the inputs' magnitude) with every other character equal.
"""
import os
import sys

import numpy as np
import pytest

from unidet3d_tpu.viz import image_vis as jax_image_vis
from unidet3d_tpu.viz import show_results as jax_show
from unidet3d_tpu_torch.viz import image_vis, show_results

# A yawed box's corners: XLA vs PyTorch float32 cos / sin (see above).
YAW_ATOL = 1e-6
PROJ = np.array([[32, 0, 32, 0], [0, 32, 32, 0], [0, 0, 1, 0], [0, 0, 0, 1]], np.float64)


def _read(path):
    with open(path) as f:
        return f.read()


def _assert_obj_close(mine: str, ref: str):
    """Equal text but for the float values on `v` lines, held within
    YAW_ATOL."""
    a, b = mine.splitlines(), ref.splitlines()
    assert len(a) == len(b)
    for la, lb in zip(a, b):
        if not la.startswith("v "):
            assert la == lb
            continue
        va = np.array(la.split()[1:], np.float64)
        vb = np.array(lb.split()[1:], np.float64)
        np.testing.assert_allclose(va, vb, rtol=0, atol=YAW_ATOL)


def _scene(seed, n=200):
    rng = np.random.RandomState(seed)
    pts = rng.rand(n, 6).astype(np.float32)
    pts[:, :3] *= 5
    pts[20:, 3:] *= 255  # the first 20 points keep colors in [0, 1]: not rescaled
    gt = np.concatenate([rng.rand(5, 3) * 5, rng.rand(5, 3) + 0.1], 1).astype(np.float32)
    pred = np.concatenate([rng.rand(4, 3) * 5, rng.rand(4, 3) + 0.1, np.zeros((4, 1))],
                          1).astype(np.float32)
    return pts, gt, pred


@pytest.mark.parametrize("seed", [0, 1])
def test_show_result_writes_the_jax_text(tmp_path, seed):
    pts, gt, pred = _scene(seed)
    mine = show_results.show_result(str(tmp_path / "mine"), "scene0", pts, gt, pred)
    ref = jax_show.show_result(str(tmp_path / "ref"), "scene0", pts, gt, pred)
    files = sorted(os.listdir(ref))
    assert files == ["scene0_gt.obj", "scene0_points.obj", "scene0_pred.obj"]
    assert sorted(os.listdir(mine)) == files
    for name in files:  # 6-column and yaw-0 boxes: byte for byte
        assert _read(os.path.join(mine, name)) == _read(os.path.join(ref, name)), name


def test_show_result_yawed_boxes(tmp_path):
    rng = np.random.RandomState(2)
    boxes = np.concatenate([rng.randn(50, 3) * 3, rng.rand(50, 3) * 2 + 0.1,
                            rng.uniform(-np.pi, np.pi, (50, 1))], 1).astype(np.float32)
    mine = show_results.show_result(str(tmp_path / "mine"), "s", pred_bboxes=boxes)
    ref = jax_show.show_result(str(tmp_path / "ref"), "s", pred_bboxes=boxes)
    assert os.listdir(mine) == os.listdir(ref) == ["s_pred.obj"]
    text = _read(os.path.join(mine, "s_pred.obj"))
    assert text.count("\nl ") == 12 * 50 and text.count("v ") == 8 * 50
    _assert_obj_close(text, _read(os.path.join(ref, "s_pred.obj")))


@pytest.mark.parametrize("ignore_index", [None, 255])
def test_show_seg_result_writes_the_jax_text(tmp_path, ignore_index):
    rng = np.random.RandomState(0)
    pts = rng.rand(100, 6).astype(np.float32)
    gt = rng.randint(0, 3, 100)
    gt[:10] = 255 if ignore_index else 2
    pred = rng.randint(0, 3, 100)
    palette = np.array([[255, 0, 0], [0, 255, 0], [0, 0, 255]], np.float32)
    mine = show_results.show_seg_result(str(tmp_path / "mine"), "scene0", pts, gt, pred,
                                        palette, ignore_index=ignore_index)
    ref = jax_show.show_seg_result(str(tmp_path / "ref"), "scene0", pts, gt, pred, palette,
                                   ignore_index=ignore_index)
    files = sorted(os.listdir(ref))
    assert sorted(os.listdir(mine)) == files == [
        "scene0_gt.obj", "scene0_points.obj", "scene0_pred.obj"]
    for name in files:
        assert _read(os.path.join(mine, name)) == _read(os.path.join(ref, name)), name


@pytest.mark.parametrize("yaw", [0.0, 0.2])
def test_show_multi_modality_result_draws_the_jax_images(tmp_path, yaw):
    from PIL import Image

    img = np.random.RandomState(0).randint(0, 50, (64, 64, 3)).astype(np.uint8)
    boxes = np.array([[0, 0, 4.0, 1, 1, 1, yaw], [0.5, -0.3, 6.0, 2, 1, 1.5, yaw]],
                     np.float32)
    mine = show_results.show_multi_modality_result(img, boxes, boxes[:1], PROJ,
                                                   str(tmp_path / "mine"), "scene0")
    ref = jax_show.show_multi_modality_result(img, boxes, boxes[:1], PROJ,
                                              str(tmp_path / "ref"), "scene0")
    files = sorted(os.listdir(ref))
    assert files == ["scene0_gt.png", "scene0_img.png", "scene0_pred.png"]
    assert sorted(os.listdir(mine)) == files
    for name in files:
        a = np.asarray(Image.open(os.path.join(mine, name)))
        b = np.asarray(Image.open(os.path.join(ref, name)))
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (np.asarray(Image.open(os.path.join(mine, "scene0_pred.png"))) != img).any()


def test_image_vis_equals_jax():
    rng = np.random.RandomState(3)
    pts = (rng.rand(500, 3) * [4, 4, 8] - [2, 2, -1]).astype(np.float32)
    np.testing.assert_array_equal(image_vis.project_points(pts, PROJ),
                                  jax_image_vis.project_points(pts, PROJ))
    img = np.zeros((64, 64, 3), np.uint8)
    np.testing.assert_array_equal(image_vis.draw_points_on_img(pts, img.copy(), PROJ),
                                  jax_image_vis.draw_points_on_img(pts, img.copy(), PROJ))
    boxes = np.array([[0, 0, 4.0, 1, 1, 1, 0.2], [1, 0, 5.0, 1, 2, 1, 0.0],
                      [0, 0, -4.0, 1, 1, 1, 0.0]], np.float32)  # the last behind the camera
    ext = np.eye(4)
    ext[0, 3] = 0.5
    for name, mat, extra in (
        ("draw_depth_bbox3d_on_img", PROJ[:3, :3], ()),  # 3x3 intrinsics
        ("draw_depth_bbox3d_on_img", PROJ, (ext,)),
        ("draw_lidar_bbox3d_on_img", PROJ, ()),
        ("draw_camera_bbox3d_on_img", PROJ, ()),
        ("draw_bbox3d_on_img", PROJ, ()),
    ):
        out = getattr(image_vis, name)(boxes, img.copy(), mat, *extra)
        ref = getattr(jax_image_vis, name)(boxes, img.copy(), mat, *extra)
        np.testing.assert_array_equal(out, ref, err_msg=name)
        assert (out != 0).any(), name


def test_show_online_raises_import_error_without_open3d(monkeypatch):
    monkeypatch.setitem(sys.modules, "open3d", None)  # import open3d raises
    with pytest.raises(ImportError, match="open3d is not installed"):
        show_results.show_online(np.zeros((4, 6), np.float32), np.zeros((1, 7), np.float32))
