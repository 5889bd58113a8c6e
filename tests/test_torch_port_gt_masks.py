"""The eval ground truth without OpenCV, against OpenCV and the JAX package:
the port's `processing.polygon_to_mask` equals `cv2.fillPoly(mask, [pts],
1)` (lineType 8, shift 0) bit for bit, on hypothesis-drawn polygons with
vertices up to 10 px outside the frame and on the degenerate cases; its
pieces, the clipped 8-connected line and `clip_line`, equal `cv2.line` and
`cv2.clipLine`; `eval_gt_lerfdata` and `eval_gt_ovsdata` (PIL masks) give
JAX's keys, masks and boxes; the room variant's nearest resize is
OpenCV's; and no module of the eval GT path imports cv2.
"""
import ast
import json
from pathlib import Path

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from langsplatv2_tpu.eval import lerf as jlerf
from langsplatv2_tpu.eval import ovs as jovs
from langsplatv2_tpu_torch.eval import lerf, ovs, processing

EVAL_DIR = Path(processing.__file__).parent


def cv2_fill(shape, pts) -> np.ndarray:
    mask = np.zeros(shape, np.uint8)
    cv2.fillPoly(mask, [np.asarray(pts, np.int32).reshape(-1, 2)], 1)
    return mask.astype(bool)


@st.composite
def polygons(draw):
    """A frame of 1..60 x 1..80 and 3..12 vertices up to 10 px outside
    it; a quarter snapped to a 6 px grid, which makes repeated vertices,
    collinear runs and horizontal and vertical edges common."""
    h = draw(st.integers(1, 60))
    w = draw(st.integers(1, 80))
    n = draw(st.integers(3, 12))
    xs = draw(st.lists(st.integers(-10, w + 9), min_size=n, max_size=n))
    ys = draw(st.lists(st.integers(-10, h + 9), min_size=n, max_size=n))
    pts = np.stack([xs, ys], 1)
    if draw(st.integers(0, 3)) == 0:
        pts = pts // 6 * 6
    return (h, w), pts


@settings(max_examples=600, deadline=None, derandomize=True, database=None)
@given(polygons())
def test_polygon_to_mask_is_cv2_fillpoly(case):
    shape, pts = case
    np.testing.assert_array_equal(processing.polygon_to_mask(shape, pts),
                                  cv2_fill(shape, pts))


DEGENERATE = {
    "one point": [[5, 7]],
    "one point outside": [[-3, 7]],
    "two points": [[2, 3], [17, 11]],
    "two points, one outside": [[-6, 3], [17, 30]],
    "repeated vertices": [[2, 2], [2, 2], [20, 4], [20, 4], [9, 18], [2, 2]],
    "collinear": [[0, 0], [5, 5], [10, 10], [15, 15]],
    "collinear with a turn back": [[3, 3], [15, 9], [7, 5], [19, 11]],
    "horizontal edges": [[2, 4], [20, 4], [20, 12], [8, 12], [8, 17],
                         [2, 17]],
    "vertical edges": [[4, 2], [4, 19], [11, 19], [11, 6], [16, 6],
                       [16, 2]],
    "bowtie": [[2, 2], [20, 18], [20, 2], [2, 18]],
    "pentagram": [[12, 1], [18, 19], [2, 7], [22, 7], [6, 19]],
    "concave": [[1, 1], [22, 1], [22, 18], [12, 6], [1, 18]],
    "all outside, around the frame": [[-5, -5], [30, -5], [30, 25],
                                      [-5, 25]],
    "all outside, beside the frame": [[-9, 2], [-1, 5], [-4, 17]],
    "touching the left border": [[-6, 20], [0, 10], [-6, 5]],
    "touching the right border": [[29, 20], [23, 10], [29, 5]],
    "crossing every border": [[-4, 10], [12, -6], [28, 9], [11, 27]],
    "far outside": [[-1000, -800], [900, 12], [5, 1100]],
    "slivers": [[0, 0], [23, 1], [0, 2], [23, 3], [0, 4]],
}


@pytest.mark.parametrize("name", list(DEGENERATE))
def test_degenerate_polygons_are_cv2_fillpoly(name):
    pts = np.asarray(DEGENERATE[name], np.int32)
    for shape in ((20, 24), (1, 24), (20, 1)):
        np.testing.assert_array_equal(processing.polygon_to_mask(shape, pts),
                                      cv2_fill(shape, pts), err_msg=name)


def test_labelme_float_vertices_truncate_as_in_jax():
    """labelme's float vertices go through np.asarray(..., np.int32), as
    in the reference."""
    pts = [[1.9, 2.7], [18.2, 3.99], [10.5, 15.01], [-2.7, 9.5]]
    np.testing.assert_array_equal(processing.polygon_to_mask((20, 24), pts),
                                  cv2_fill((20, 24), np.asarray(pts,
                                                                np.int32)))


@settings(max_examples=300, deadline=None, derandomize=True, database=None)
@given(st.integers(1, 40), st.integers(1, 40),
       st.lists(st.integers(-25, 65), min_size=4, max_size=4))
def test_line_and_clip_are_cv2s(w, h, ends):
    x1, y1, x2, y2 = ends
    ok, p1, p2 = cv2.clipLine((0, 0, w, h), (x1, y1), (x2, y2))
    mine = processing.clip_line(w, h, x1, y1, x2, y2)
    assert mine[0] == ok
    if ok:
        assert mine[1:] == (*p1, *p2)
    ref = np.zeros((h, w), np.uint8)
    cv2.line(ref, (x1, y1), (x2, y2), 1, 1, cv2.LINE_8)
    got = np.zeros((h, w), np.uint8)
    processing.draw_line(got, x1, y1, x2, y2)
    np.testing.assert_array_equal(got, ref)


def _labelme_dir(root: Path) -> Path:
    """Two labelme frames of 45 x 60: rectangles, a repeated label, a
    concave and a self-intersecting polygon, vertices outside the frame
    and float coordinates."""
    label = root / "label"
    label.mkdir(parents=True)
    frames = {
        "frame_00001.jpg": [
            ("cup", [3, 4, 20, 15], [[3, 4], [20, 4], [20, 15], [3, 15]]),
            ("cup", [30, 20, 50, 40],
             [[30, 20], [50, 20], [50, 40], [30, 40]]),
            ("plant", [-5, 10, 25, 52],
             [[-5, 10], [25, 12.6], [12.2, 30], [25, 52], [-5, 44]]),
        ],
        "frame_00002.jpg": [
            ("book", [2, 2, 58, 40],
             [[2, 2], [58, 40], [58, 2], [2, 40]]),
            ("lamp", [40, -3, 66, 20],
             [[40.7, -3], [66, 5], [47, 20.9], [55, 8]]),
        ],
    }
    for name, objects in frames.items():
        with open(label / name.replace(".jpg", ".json"), "w") as f:
            json.dump({"info": {"name": name, "height": 45, "width": 60},
                       "objects": [{"category": c, "bbox": b,
                                    "segmentation": s}
                                   for c, b, s in objects]}, f)
    return label


def test_lerf_gt_matches_jax(tmp_path):
    label = _labelme_dir(tmp_path)
    out, hw, paths = lerf.eval_gt_lerfdata(str(label),
                                           str(tmp_path / "port"))
    ref, hw_ref, ref_paths = jlerf.eval_gt_lerfdata(str(label),
                                                    str(tmp_path / "jax"))
    assert hw == hw_ref == (45, 60) and paths == ref_paths
    assert list(out) == list(ref) == ["0", "1"]
    for frame in out:
        assert list(out[frame]) == list(ref[frame])
        for label_name, ann in out[frame].items():
            np.testing.assert_array_equal(ann["mask"],
                                          ref[frame][label_name]["mask"])
            np.testing.assert_array_equal(ann["bboxes"],
                                          ref[frame][label_name]["bboxes"])
    assert out["0"]["cup"]["bboxes"].shape == (2, 4)
    written = sorted(p.relative_to(tmp_path / "port")
                     for p in (tmp_path / "port").rglob("*.jpg"))
    assert written == sorted(p.relative_to(tmp_path / "jax")
                             for p in (tmp_path / "jax").rglob("*.jpg"))
    with Image.open(tmp_path / "port" / "gt" / "frame_00001" /
                    "cup.jpg") as im:
        assert im.size == (60, 45)


def _png_masks(root: Path) -> Path:
    """Two frames of PNG masks in the forms a mask folder holds: grey,
    RGB with channels that differ (cv2 reads the blue one), a palette,
    grey with alpha, RGBA, and values other than 0 and 255; 'wood wall'
    goes last, a text file is skipped."""
    seg = root / "segmentations"
    rng = np.random.default_rng(3)
    for fid in ("frame_a", "frame_b"):
        d = seg / fid
        d.mkdir(parents=True)
        m = (rng.uniform(size=(18, 26)) > 0.5).astype(np.uint8) * 255
        Image.fromarray(m).save(d / "wood wall.png")
        Image.fromarray(m[::-1]).save(d / "cup.png")
        rgb = np.stack([m, 255 - m, m[:, ::-1]], -1)
        Image.fromarray(rgb).save(d / "chair.png")
        pal = Image.fromarray(m // 255).convert("P")
        pal.putpalette([0, 0, 0, 10, 20, 255] + [0] * 762)
        pal.save(d / "lamp.png")
        Image.fromarray(np.stack([m, m[::-1]], -1), "LA").save(
            d / "table.png")
        Image.fromarray(np.dstack([rgb, m]), "RGBA").save(d / "sofa.png")
        Image.fromarray(rng.integers(0, 256, (18, 26)).astype(np.uint8)
                        ).save(d / "rug.png")
    (seg / "notes.txt").write_text("skipped")
    return seg


def test_ovs_gt_matches_jax(tmp_path):
    seg = _png_masks(tmp_path)
    out, ids = ovs.eval_gt_ovsdata(str(seg), str(tmp_path / "port"))
    ref, ref_ids = jovs.eval_gt_ovsdata(str(seg), str(tmp_path / "jax"))
    assert ids == ref_ids == ["frame_a", "frame_b"]
    for fid in ids:
        assert list(out[fid]) == list(ref[fid])
        assert list(out[fid])[-1] == "wood wall"
        for p in out[fid]:
            np.testing.assert_array_equal(out[fid][p]["mask"],
                                          ref[fid][p]["mask"], err_msg=p)
    written = sorted(p.relative_to(tmp_path / "port")
                     for p in (tmp_path / "port").rglob("*.jpg"))
    assert len(written) == 14 and written == sorted(
        p.relative_to(tmp_path / "jax")
        for p in (tmp_path / "jax").rglob("*.jpg"))


def test_room_gt_resize_matches_jax():
    """The room variant scores GT masks of another size after OpenCV's
    nearest resize: the port's numpy resize gives JAX's IoUs and levels."""
    rng = np.random.default_rng(8)
    vm = rng.uniform(size=(3, 4, 24, 30)).astype(np.float32)
    prompts = ["a", "b", "c", "wood wall"]
    gt = {p: (rng.uniform(size=(37, 19)) > 0.6).astype(np.uint8)
          for p in prompts}
    out = ovs.segmentation_process_room(vm, 0.4, gt, prompts)
    ref = jovs.segmentation_process_room(jnp.asarray(vm), 0.4, gt, prompts)
    np.testing.assert_allclose(out[0], ref[0], atol=1e-6)
    assert out[1] == list(ref[1])


def test_eval_gt_path_imports_no_cv2():
    for name in ("processing.py", "lerf.py", "ovs.py"):
        tree = ast.parse((EVAL_DIR / name).read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            assert not any(m.split(".")[0] == "cv2" for m in mods), name
