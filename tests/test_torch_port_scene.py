"""The port's scene loading against the JAX package: the COLMAP readers
and writers, the scene-info readers (COLMAP and Blender), `load_camera`'s
images and `camera_to_json`, `Scene` (camera order under one seed,
cameras.json, input.ply), the per-pixel language GT
(`Camera.get_language_feature`) through the native loader and the numpy
path, the native loader itself (its own copy of the C++ source, built into
build/), the pixel-space losses (l2, safe_norm, cos), SH degree 4 in
`create_from_pcd` and the PLY files.

JAX's modules read the same files; every comparison is exact unless it
says otherwise.
"""
import json
import os
import random
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from langsplatv2_tpu import native as jax_native
from langsplatv2_tpu.models import gaussians as jax_gm
from langsplatv2_tpu.models import io as jax_io
from langsplatv2_tpu.scene import colmap as jax_colmap
from langsplatv2_tpu.scene import dataset as jax_dataset
from langsplatv2_tpu.scene.cameras import Camera as JaxCamera
from langsplatv2_tpu.scene.scene import Scene as JaxScene
from langsplatv2_tpu.utils import losses as jax_losses
from langsplatv2_tpu_torch import native
from langsplatv2_tpu_torch.models import io
from langsplatv2_tpu_torch.models.gaussians import create_from_pcd
from langsplatv2_tpu_torch.scene import colmap, dataset
from langsplatv2_tpu_torch.scene.cameras import Camera
from langsplatv2_tpu_torch.scene.scene import Scene
from langsplatv2_tpu_torch.utils import losses

CAMERA_FIELDS = ("R", "T", "FoVx", "FoVy", "image", "image_name", "uid",
                 "colmap_id", "image_width", "image_height",
                 "world_view_transform", "full_proj_transform",
                 "camera_center")


def _assert_cameras_equal(mine, ref):
    for name in CAMERA_FIELDS:
        a, b = getattr(mine, name), getattr(ref, name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert a == b, name


# ------------------------------------------------------------ the losses

def test_pixel_losses_match_jax():
    """l2_loss, safe_norm and cos_loss: values and gradients at 1e-6, with
    zero vectors among the rows (safe_norm's constant branch)."""
    rng = np.random.default_rng(0)
    a = rng.normal(size=(16, 9, 7)).astype(np.float32)
    b = rng.normal(size=(16, 9, 7)).astype(np.float32)
    a[:, 0, :3] = 0.0
    b[:, 1, 2:5] = 0.0
    for dim in (0, 2):
        fns = [(losses.l2_loss, jax_losses.l2_loss, {}),
               (lambda x, y: losses.cos_loss(x, y, dim),
                lambda x, y: jax_losses.cos_loss(x, y, dim), {}),
               (lambda x, y: losses.safe_norm(x * y, dim).sum(),
                lambda x, y: jax_losses.safe_norm(x * y, dim).sum(), {})]
        for port_fn, jax_fn, _ in fns:
            ta = torch.from_numpy(a).requires_grad_(True)
            tb = torch.from_numpy(b).requires_grad_(True)
            v = port_fn(ta, tb)
            v.backward()
            rv, (ga, gb) = jax.value_and_grad(jax_fn, argnums=(0, 1))(
                jnp.asarray(a), jnp.asarray(b))
            np.testing.assert_allclose(float(v.detach()), float(rv), rtol=1e-6,
                                       atol=1e-6)
            for g, r in ((ta.grad, ga), (tb.grad, gb)):
                assert np.isfinite(g.numpy()).all()
                np.testing.assert_allclose(g.numpy(), np.asarray(r),
                                           rtol=1e-6, atol=1e-6)


# --------------------------------------------------- the native loader

def _write_features(d, name, levels=4, h=37, w=53, n_seg=17, d_feat=512,
                    f16=False, seed=0):
    rng = np.random.default_rng(seed)
    seg = rng.integers(-1, n_seg, (levels, h, w)).astype(np.int32)
    feat = rng.normal(size=(n_seg, d_feat)).astype(
        np.float16 if f16 else np.float32)
    np.save(os.path.join(d, name + "_s.npy"), seg)
    np.save(os.path.join(d, name + "_f.npy"), feat)
    return seg, feat


def test_native_builds_into_build_dir():
    assert native.available()
    assert native.LIB_PATH.exists()
    assert native.LIB_PATH.parent.parts[-3:] == ("build",
                                                 "langsplatv2_tpu_torch",
                                                 "native")


@pytest.mark.parametrize("f16,level,size", [
    (False, 2, None), (True, 2, None), (False, 1, (48, 62)),
    (True, 3, (72, 93))], ids=["f32", "f16", "resized", "resized-f16"])
def test_native_loader_matches_jax(tmp_path, f16, level, size):
    """test_native.py's cases: the port's loader against JAX's and against
    the port's numpy path (the segment map resized by exact multiples, so
    every nearest rule agrees)."""
    h, w = (24, 31) if size else (37, 53)
    seg, feat = _write_features(str(tmp_path), "img", h=h, w=w, f16=f16)
    H, W = size or (h, w)
    args = (str(tmp_path / "img_s.npy"), str(tmp_path / "img_f.npy"), level,
            H, W)
    got_f, got_m = native.load_language_feature(*args)
    ref_f, ref_m = jax_native.load_language_feature(*args)
    np.testing.assert_array_equal(got_f, ref_f)
    np.testing.assert_array_equal(got_m, ref_m)
    cam = Camera(0, np.eye(3), np.zeros(3), 1.0, 0.8, None, "img", 0, W, H)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "load_language_feature", lambda *a, **k: None)
        np_f, np_m = cam.get_language_feature(str(tmp_path), level)
    np.testing.assert_array_equal(np_f, got_f)
    np.testing.assert_array_equal(np_m, got_m)


def test_native_points3d_matches_jax(tmp_path):
    """points3D.bin with tracks: the native reader, the colmap reader (its
    native path and its struct path) against JAX's."""
    rng = np.random.default_rng(1)
    n = 57
    xyz = rng.normal(size=(n, 3))
    rgb = rng.integers(0, 256, (n, 3)).astype(np.uint8)
    err = rng.uniform(0, 2, n)
    path = tmp_path / "points3D.bin"
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", n))
        for i in range(n):
            f.write(struct.pack("<QdddBBBd", i, *xyz[i], *rgb[i], err[i]))
            track = int(rng.integers(0, 5))
            f.write(struct.pack("<Q", track) + b"\0" * (8 * track))
    out = native.read_points3d_bin(str(path))
    ref = jax_native.read_points3d_bin(str(path))
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(out[1], rgb)
    mine = colmap.read_points3d_binary(str(path))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "read_points3d_bin", lambda p: None)
        slow = colmap.read_points3d_binary(str(path))
    for a, b, c in zip(mine, slow, jax_colmap.read_points3d_binary(str(path))):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, c)


# ------------------------------------------------- COLMAP, cameras, scene

def _make_sparse(root, rng, n_imgs=9, n_pts=50, text=False):
    """tests/test_scene_io.py TestColmap._make_sparse, written with the
    JAX package's writers (binary) or as text."""
    sparse = root / "sparse" / "0"
    os.makedirs(sparse)
    cams = {1: jax_colmap.ColmapCamera(1, "PINHOLE", 64, 48,
                                       np.array([60.0, 58.0, 32.0, 24.0]))}
    images = {}
    for i in range(1, n_imgs + 1):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        images[i] = jax_colmap.ColmapImage(i, q, rng.normal(size=3), 1,
                                           f"img_{i:03d}.png")
    xyz = rng.normal(size=(n_pts, 3))
    rgb = rng.uniform(size=(n_pts, 3))
    if text:
        with open(sparse / "cameras.txt", "w") as f:
            f.write("# comment\n1 PINHOLE 64 48 60.0 58.0 32.0 24.0\n")
        with open(sparse / "images.txt", "w") as f:
            for im in images.values():
                f.write(f"{im.id} {' '.join(map(repr, im.qvec.tolist()))} "
                        f"{' '.join(map(repr, im.tvec.tolist()))} 1 "
                        f"{im.name}\n1.5 2.5 -1\n")
        with open(sparse / "points3D.txt", "w") as f:
            for i, (p, c) in enumerate(zip(xyz.tolist(),
                                           (rgb * 255).astype(int))):
                f.write(f"{i} {p[0]!r} {p[1]!r} {p[2]!r} {c[0]} {c[1]} "
                        f"{c[2]} 0.5\n")
    else:
        jax_colmap.write_intrinsics_binary(str(sparse / "cameras.bin"), cams)
        jax_colmap.write_extrinsics_binary(str(sparse / "images.bin"), images)
        jax_colmap.write_points3d_binary(str(sparse / "points3D.bin"), xyz,
                                         rgb)
    return cams, images, xyz, rgb


def _write_images(root, rng, n_imgs=9, mode="RGB", h=48, w=64):
    imgdir = root / "images"
    os.makedirs(imgdir, exist_ok=True)
    c = {"RGB": 3, "RGBA": 4, "L": 1}[mode]
    for i in range(1, n_imgs + 1):
        a = (rng.uniform(size=(h, w, c)) * 255).astype(np.uint8)
        Image.fromarray(a[..., 0] if c == 1 else a, mode).save(
            imgdir / f"img_{i:03d}.png")


def test_colmap_binary_round_trip(tmp_path):
    """The port's writers and readers against JAX's, byte for byte and
    value for value, and qvec_to_rotmat."""
    rng = np.random.default_rng(2)
    cams, images, xyz, rgb = _make_sparse(tmp_path, rng)
    sparse = tmp_path / "sparse" / "0"
    mine = tmp_path / "mine"
    os.makedirs(mine)
    colmap.write_intrinsics_binary(str(mine / "cameras.bin"), {
        k: colmap.ColmapCamera(v.id, v.model, v.width, v.height, v.params)
        for k, v in cams.items()})
    colmap.write_extrinsics_binary(str(mine / "images.bin"), {
        k: colmap.ColmapImage(v.id, v.qvec, v.tvec, v.camera_id, v.name)
        for k, v in images.items()})
    colmap.write_points3d_binary(str(mine / "points3D.bin"), xyz, rgb)
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        assert (mine / name).read_bytes() == (sparse / name).read_bytes()
    rc = colmap.read_intrinsics_binary(str(sparse / "cameras.bin"))
    ri = colmap.read_extrinsics_binary(str(sparse / "images.bin"))
    assert rc[1].model == "PINHOLE" and len(ri) == 9
    np.testing.assert_array_equal(rc[1].params, cams[1].params)
    for k, im in images.items():
        np.testing.assert_array_equal(ri[k].qvec, im.qvec)
        np.testing.assert_array_equal(ri[k].tvec, im.tvec)
        assert ri[k].name == im.name
        np.testing.assert_array_equal(colmap.qvec_to_rotmat(im.qvec),
                                      jax_colmap.qvec_to_rotmat(im.qvec))
    rx, rrgb, _ = colmap.read_points3d_binary(str(sparse / "points3D.bin"))
    np.testing.assert_array_equal(rx, xyz)
    np.testing.assert_allclose(rrgb, rgb, atol=1 / 255)


@pytest.mark.parametrize("text", [False, True], ids=["binary", "text"])
def test_colmap_scene_info_and_cameras_match_jax(tmp_path, text):
    """read_colmap_scene_info (eval split, nerf++ norm, the points and the
    points3D.ply it writes), load_camera at native size (PNG) and at
    resolution 2 (a PIL resize), camera_to_json."""
    rng = np.random.default_rng(3)
    _make_sparse(tmp_path, rng, text=text)
    _write_images(tmp_path, rng)
    info = dataset.read_colmap_scene_info(str(tmp_path), eval_split=True)
    ply = tmp_path / "sparse" / "0" / "points3D.ply"
    ply_bytes = ply.read_bytes()
    os.remove(ply)
    ref = jax_dataset.read_colmap_scene_info(str(tmp_path), eval_split=True)
    assert ply.read_bytes() == ply_bytes
    assert len(info.train_cameras) == 7 and len(info.test_cameras) == 2
    assert info.nerf_normalization["radius"] == \
        ref.nerf_normalization["radius"]
    np.testing.assert_array_equal(info.nerf_normalization["translate"],
                                  ref.nerf_normalization["translate"])
    np.testing.assert_array_equal(info.points, ref.points)
    np.testing.assert_array_equal(info.colors, ref.colors)
    for mine, theirs in zip(info.train_cameras + info.test_cameras,
                            ref.train_cameras + ref.test_cameras):
        for name in ("uid", "FovY", "FovX", "image_path", "image_name",
                     "width", "height"):
            assert getattr(mine, name) == getattr(theirs, name), name
        np.testing.assert_array_equal(mine.R, theirs.R)
        np.testing.assert_array_equal(mine.T, theirs.T)
        assert dataset.camera_to_json(3, mine) == \
            jax_dataset.camera_to_json(3, theirs)
    for resolution in (-1, 2):
        for uid, (a, b) in enumerate(zip(info.train_cameras[:2],
                                         ref.train_cameras[:2])):
            _assert_cameras_equal(dataset.load_camera(a, 1.0, resolution, uid),
                                  jax_dataset.load_camera(b, 1.0, resolution,
                                                          uid))
    if text:
        # An image without 2-D points has an empty points line.
        path = tmp_path / "sparse" / "0" / "images.txt"
        path.write_text(path.read_text().replace("1.5 2.5 -1\n", "\n"))
        assert len(colmap.read_extrinsics_text(str(path))) == 9
    # A second read takes the points3D.ply the first one wrote.
    again = dataset.read_colmap_scene_info(str(tmp_path))
    np.testing.assert_array_equal(again.points, ref.points.astype(
        np.float32).astype(np.float64))


@pytest.mark.parametrize("mode", ["RGBA", "L"])
def test_blender_scene_info_and_cameras_match_jax(tmp_path, mode):
    """transforms_{train,test}.json: the camera infos, the random point
    cloud it writes, and RGBA (alpha premultiplied) and gray images."""
    rng = np.random.default_rng(4)
    frames = {}
    for split, count in (("train", 3), ("test", 2)):
        frames[split] = []
        for i in range(count):
            c2w = np.eye(4)
            c2w[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
            c2w[:3, 3] = rng.normal(size=3) * 3
            frames[split].append({"file_path": f"./{split}/r_{i}",
                                  "transform_matrix": c2w.tolist()})
            os.makedirs(tmp_path / split, exist_ok=True)
            c = 4 if mode == "RGBA" else 1
            a = (rng.uniform(size=(20, 30, c)) * 255).astype(np.uint8)
            Image.fromarray(a[..., 0] if c == 1 else a, mode).save(
                tmp_path / split / f"r_{i}.png")
        with open(tmp_path / f"transforms_{split}.json", "w") as f:
            json.dump({"camera_angle_x": 0.69, "frames": frames[split]}, f)
    info = dataset.read_blender_scene_info(str(tmp_path), True, True)
    ply_bytes = (tmp_path / "points3d.ply").read_bytes()
    os.remove(tmp_path / "points3d.ply")
    ref = jax_dataset.read_blender_scene_info(str(tmp_path), True, True)
    assert (tmp_path / "points3d.ply").read_bytes() == ply_bytes
    assert info.is_blender and len(info.test_cameras) == 2
    np.testing.assert_array_equal(info.points, ref.points)
    for uid, (a, b) in enumerate(zip(info.train_cameras + info.test_cameras,
                                     ref.train_cameras + ref.test_cameras)):
        assert (a.width, a.height, a.FovX, a.FovY) == \
            (b.width, b.height, b.FovX, b.FovY)
        cam = dataset.load_camera(a, 1.0, -1, uid)
        _assert_cameras_equal(cam, jax_dataset.load_camera(b, 1.0, -1, uid))
        assert cam.image.shape[0] == (3 if mode == "RGBA" else 1)


def test_scene_assembly(tmp_path):
    """Scene under one seed of Python's global random: the same camera
    order (train and test), extent, cameras.json and input.ply as JAX's."""
    rng = np.random.default_rng(5)
    _make_sparse(tmp_path, rng)
    _write_images(tmp_path, rng)
    random.seed(7)
    scene = Scene(str(tmp_path), str(tmp_path / "out"), eval_split=True)
    random.seed(7)
    ref = JaxScene(str(tmp_path), str(tmp_path / "ref"), eval_split=True)
    assert scene.cameras_extent == ref.cameras_extent
    assert [c.image_name for c in scene.get_train_cameras()] != sorted(
        c.image_name for c in scene.get_train_cameras())
    for mine, theirs in ((scene.get_train_cameras(), ref.get_train_cameras()),
                         (scene.get_test_cameras(), ref.get_test_cameras())):
        assert len(mine) == len(theirs) > 0
        for a, b in zip(mine, theirs):
            _assert_cameras_equal(a, b)
    for name in ("cameras.json", "input.ply"):
        assert (tmp_path / "out" / name).read_bytes() == \
            (tmp_path / "ref" / name).read_bytes(), name


def test_language_feature_matches_jax(tmp_path):
    """Camera.get_language_feature, features and mask, same size and a
    segment map at half size, and the compact form's equal pixels."""
    rng = np.random.default_rng(6)
    seg = rng.integers(-1, 6, (4, 12, 16)).astype(np.int32)
    np.save(tmp_path / "im0_s.npy", seg)
    np.save(tmp_path / "im0_f.npy", rng.normal(size=(6, 512)).astype(
        np.float32))
    for H, W in ((12, 16), (24, 32)):
        mine = Camera(0, np.eye(3), np.zeros(3), 1.0, 0.8, None, "im0", 0, W,
                      H)
        ref = JaxCamera(0, np.eye(3), np.zeros(3), 1.0, 0.8, None, "im0", 0,
                        W, H)
        for level in (0, 3):
            f, m = mine.get_language_feature(str(tmp_path), level)
            rf, rm = ref.get_language_feature(str(tmp_path), level)
            assert f.dtype == np.float32 and f.shape == (512, H, W)
            np.testing.assert_array_equal(f, rf)
            np.testing.assert_array_equal(m, rm)
            table, s = mine.get_language_feature_compact(str(tmp_path), level)
            np.testing.assert_array_equal(
                np.where(m[0], table[np.clip(s, 0, None)].transpose(2, 0, 1),
                         0), np.where(m[0], f, 0))
    with pytest.raises(ValueError, match="feature_level"):
        mine.get_language_feature(str(tmp_path), 4)


# ------------------------------------------------------------ SH degree 4

def test_sh4_model_and_ply_match_jax(tmp_path):
    """create_from_pcd at SH 4 (24 rest coefficients) against JAX's, and
    its PLY (72 f_rest fields) read across the packages."""
    rng = np.random.default_rng(8)
    pts = rng.normal(size=(40, 3)).astype(np.float32)
    cols = rng.uniform(size=(40, 3)).astype(np.float32)
    model = create_from_pcd(pts, cols, 2.0, max_sh_degree=4, capacity=64,
                            device="cpu")
    jm = jax_gm.create_from_pcd(pts, cols, 2.0, max_sh_degree=4, capacity=64)
    assert tuple(model.features_rest.shape) == (64, 24, 3)
    for name in ("xyz", "features_dc", "features_rest", "scaling",
                 "rotation", "opacity"):
        np.testing.assert_allclose(getattr(model, name).detach().numpy(),
                                   np.asarray(getattr(jm, name)), rtol=1e-6,
                                   atol=1e-6, err_msg=name)
    rest = rng.normal(size=(64, 24, 3)).astype(np.float32)
    model = model.replace(features_rest=torch.from_numpy(rest))
    path = str(tmp_path / "p.ply")
    io.save_ply(model, path)
    back = io.load_ply(path, max_sh_degree=4, device="cpu")
    jback = jax_io.load_ply(path, max_sh_degree=4)
    np.testing.assert_array_equal(back.features_rest.numpy(), rest[:40])
    np.testing.assert_array_equal(back.features_rest.numpy(),
                                  np.asarray(jback.features_rest))
    with pytest.raises(ValueError, match="72 f_rest fields"):
        io.load_ply(path, max_sh_degree=3, device="cpu")
