"""The port's preprocess stage (langsplatv2_tpu_torch/preprocess/) against
JAX's (langsplatv2_tpu/preprocess/) and OpenCV, on the CPU:

- `resize_linear_u8` equal to cv2.resize at INTER_LINEAR bit for bit
  (crops padded to sides 1-600, 224 and the exact 2x of 448 among them; a
  1100-row image to 1080), `resize_linear_f32` within 1e-6 of the
  largest (cv2's own float path, equal in practice);
- mask_iou_matrices, mask_nms and masks_update equal to JAX's (score
  ties included), mask_to_segmap's tiles and seg maps equal;
- the pipeline's `_s.npy` / `_f.npy` files byte-equal to JAX's with
  tests/test_preprocess.py's synthetic generator and the hash backend;
- `load_images` on PNGs (one taller than 1080) equal to JAX's cv2 reads;
- the cluster segmenter: cv2's component order, JAX's `_masks_for` fed
  the port's k-means labels (through a patched cv2.kmeans) gives the
  port's masks, the port's k-means objective within 1.10x of cv2's;
- the command line against scripts/preprocess.py (cv2.kmeans patched the
  same way), `convert` against scripts/convert.py (fake colmap and magick
  executables record their arguments), `tools.inspect_features` against
  scripts/inspect_features.py's arithmetic;
- the CLIP encoders placed on the device they are given.
"""
import importlib.util
import io
import os
import stat
import sys
import types
from contextlib import redirect_stdout
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from langsplatv2_tpu.preprocess import masks as jax_masks
from langsplatv2_tpu.preprocess import pipeline as jax_pipeline
from langsplatv2_tpu_torch.eval import openclip
from langsplatv2_tpu_torch.preprocess import cli, convert
from langsplatv2_tpu_torch.preprocess import masks as port_masks
from langsplatv2_tpu_torch.preprocess import pipeline as port_pipeline
from langsplatv2_tpu_torch.preprocess.resize import (resize_linear_f32,
                                                     resize_linear_u8)
from langsplatv2_tpu_torch.scene.cameras import Camera
from langsplatv2_tpu_torch.tools import inspect_features

REPO = Path(__file__).resolve().parents[1]


def _script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_script(name: str, argv: list, monkeypatch) -> str:
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    out = io.StringIO()
    with redirect_stdout(out):
        _script(name).main()
    return out.getvalue()


# ------------------------------------------------------------------ resize

def padded_crop(rng, h: int, w: int) -> np.ndarray:
    crop = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    return jax_masks.pad_img(crop)


@pytest.mark.parametrize("seed", range(4))
def test_resize_u8_tiles_equal_cv2(seed):
    rng = np.random.default_rng(seed)
    sides = [(int(a), int(b)) for a, b in rng.integers(1, 601, (12, 2))]
    sides += [(224, 224), (448, 448), (448, 300), (1, 1), (600, 2)][seed::4]
    for h, w in sides:
        tile = padded_crop(rng, h, w)
        got = resize_linear_u8(torch.from_numpy(tile), 224, 224).numpy()
        np.testing.assert_array_equal(got, cv2.resize(tile, (224, 224)),
                                      err_msg=str((h, w)))


def test_resize_u8_any_shape_and_height_cap():
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (1100, 1467, 3), dtype=np.uint8)
    w = round(1467 * 1080 / 1100)
    np.testing.assert_array_equal(
        resize_linear_u8(torch.from_numpy(img), w, 1080).numpy(),
        cv2.resize(img, (w, 1080), interpolation=cv2.INTER_LINEAR))
    for _ in range(30):
        h0, w0, h1, w1 = (int(v) for v in rng.integers(1, 200, 4))
        x = rng.integers(0, 256, (h0, w0, 3), dtype=np.uint8)
        np.testing.assert_array_equal(
            resize_linear_u8(torch.from_numpy(x), w1, h1).numpy(),
            cv2.resize(x, (w1, h1)), err_msg=str((h0, w0, h1, w1)))


def test_resize_f32_matches_cv2():
    rng = np.random.default_rng(8)
    shapes = [(192, 256, 48, 64), (16, 16, 48, 64), (16, 12, 48, 64),
              (1, 9, 4, 5), (9, 1, 4, 5), (20, 30, 10, 15)]
    shapes += [tuple(int(v) for v in rng.integers(2, 120, 4))
               for _ in range(20)]
    for h0, w0, h1, w1 in shapes:
        x = (rng.standard_normal((3, h0, w0)) * 5).astype(np.float32)
        got = resize_linear_f32(torch.from_numpy(x), w1, h1).numpy()
        for g, m in zip(got, x):
            ref = cv2.resize(m, (w1, h1), interpolation=cv2.INTER_LINEAR)
            assert np.abs(g - ref).max() <= 1e-6 * np.abs(ref).max(), \
                (h0, w0, h1, w1)


# ------------------------------------------------------------------- masks

def make_mask(h, w, y0, y1, x0, x1, iou=0.9, stab=0.95):
    seg = np.zeros((h, w), bool)
    seg[y0:y1, x0:x1] = True
    return {"segmentation": seg, "bbox": [x0, y0, x1 - x0, y1 - y0],
            "predicted_iou": iou, "stability_score": stab}


def random_masks(rng, n: int, h: int, w: int, tie_every: int = 3):
    out = []
    for i in range(n):
        y0, x0 = (int(v) for v in rng.integers(0, [h - 2, w - 2]))
        y1 = int(rng.integers(y0 + 1, h + 1))
        x1 = int(rng.integers(x0 + 1, w + 1))
        m = make_mask(h, w, y0, y1, x0, x1,
                      iou=0.9 if i % tie_every == 0 else
                      float(rng.uniform(0.5, 1.0)),
                      stab=0.95 if i % tie_every == 0 else
                      float(rng.uniform(0.5, 1.0)))
        m["segmentation"] &= rng.uniform(size=(h, w)) > 0.1
        out.append(m)
    return out


@pytest.mark.parametrize("seed", range(3))
def test_nms_and_update_equal_jax(seed):
    rng = np.random.default_rng(seed)
    ms = random_masks(rng, 40, 24, 32)
    # nested and duplicated masks exercise the inner-overlap gates
    ms += [make_mask(24, 32, 0, 24, 0, 32, 0.9, 0.95),
           make_mask(24, 32, 2, 6, 2, 6, 0.9, 0.95),
           make_mask(24, 32, 2, 6, 2, 6, 0.8, 0.95)]
    seg = np.stack([m["segmentation"] for m in ms])
    iou, inter, areas = port_masks.mask_iou_matrices(seg, device="cpu")
    r_iou, r_inter, r_areas = jax_masks.mask_iou_matrices(seg)
    np.testing.assert_array_equal(inter, r_inter)
    np.testing.assert_array_equal(areas, r_areas)
    np.testing.assert_array_equal(iou, r_iou)
    np.testing.assert_array_equal(
        inter, (seg[:, None].astype(np.int64) & seg[None].astype(np.int64))
        .sum((-2, -1)))
    scores = np.asarray([m["stability_score"] * m["predicted_iou"]
                         for m in ms])
    for kw in (dict(iou_thr=0.7, score_thr=0.1, inner_thr=0.2),
               dict(iou_thr=0.3, score_thr=0.99, inner_thr=0.5)):
        np.testing.assert_array_equal(
            port_masks.mask_nms(seg, scores, device="cpu", **kw),
            jax_masks.mask_nms(seg, scores, **kw))
    lv = [ms[:15], ms[15:], [], ms[-3:]]
    got = port_masks.masks_update(*lv, device="cpu")
    ref = jax_masks.masks_update(*lv)
    assert [[id(m) for m in a] for a in got] == \
        [[id(m) for m in a] for a in ref]


def test_segmap_tiles_equal_jax():
    rng = np.random.default_rng(4)
    h, w = 60, 90
    image = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    ms = random_masks(rng, 12, h, w)
    for m in ms:      # boxes from the pixels, as the generators give them
        ys, xs = np.nonzero(m["segmentation"])
        m["bbox"] = [int(xs.min()), int(ys.min()),
                     int(xs.max() - xs.min() + 1), int(ys.max() - ys.min() + 1)]
    big = rng.integers(0, 256, (448, 448, 3), dtype=np.uint8)
    tiles, seg = port_masks.mask_to_segmap(ms, image, device="cpu")
    r_tiles, r_seg = jax_masks.mask_to_segmap(ms, image)
    assert tiles.dtype == torch.float32 and seg.dtype == torch.int32
    np.testing.assert_array_equal(tiles.numpy(), r_tiles)
    np.testing.assert_array_equal(seg.numpy(), r_seg)
    whole = [make_mask(448, 448, 0, 448, 0, 448)]     # the 2x tile path
    np.testing.assert_array_equal(
        port_masks.mask_to_segmap(whole, big, device="cpu")[0].numpy(),
        jax_masks.mask_to_segmap(whole, big)[0])


def synthetic_generator(image):
    """tests/test_preprocess.py's generator."""
    h, w = image.shape[:2]
    half = [make_mask(h, w, 0, h // 2, 0, w), make_mask(h, w, h // 2, h, 0, w)]
    quad = [make_mask(h, w, 0, h // 2, 0, w // 2),
            make_mask(h, w, 0, h // 2, w // 2, w),
            make_mask(h, w, h // 2, h, 0, w // 2),
            make_mask(h, w, h // 2, h, w // 2, w)]
    whole = [make_mask(h, w, 0, h, 0, w)]
    return (half, quad, half, whole)


def assert_same_files(a: Path, b: Path, names):
    for n in names:
        for suffix in ("_s.npy", "_f.npy"):
            assert (a / (n + suffix)).read_bytes() == \
                (b / (n + suffix)).read_bytes(), n + suffix


def test_pipeline_files_equal_jax(tmp_path):
    rng = np.random.default_rng(0)
    images = [(rng.uniform(size=(64, 64, 3)) * 255).astype(np.uint8),
              (rng.uniform(size=(50, 70, 3)) * 255).astype(np.uint8)]
    names = ["im0.png", "im1.jpg"]
    jax_pipeline.PreprocessPipeline(synthetic_generator, "hash").run(
        images, names, str(tmp_path / "jax"))
    port_pipeline.create(images, names, str(tmp_path / "port"),
                         synthetic_generator, "hash", device="cpu")
    assert_same_files(tmp_path / "jax", tmp_path / "port", ["im0", "im1"])
    feats, seg = port_pipeline.PreprocessPipeline(
        synthetic_generator, "hash", device="cpu").process_image(images[0])
    assert feats.shape == (9, 512) and seg.shape == (4, 64, 64)
    assert set(np.unique(seg[1])) == {2, 3, 4, 5}


def write_pngs(root: Path, images: dict) -> None:
    (root / "images").mkdir(parents=True)
    for name, img in images.items():
        Image.fromarray(img).save(root / "images" / name)


def test_load_images_equal_jax(tmp_path):
    rng = np.random.default_rng(5)
    write_pngs(tmp_path, {
        "a.png": rng.integers(0, 256, (40, 60, 3), dtype=np.uint8),
        "b.png": rng.integers(0, 256, (1100, 733, 3), dtype=np.uint8),
        "c.png": rng.integers(0, 256, (1080, 30, 3), dtype=np.uint8)})
    (tmp_path / "images" / "notes.txt").write_text("not an image")
    got, names = port_pipeline.load_images(str(tmp_path), device="cpu")
    ref, r_names = jax_pipeline.load_images(str(tmp_path))
    assert names == r_names == ["a.png", "b.png", "c.png"]
    assert got[1].shape == (1080, round(733 * 1080 / 1100), 3)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    small, _ = port_pipeline.load_images(str(tmp_path), 50, device="cpu")
    small_ref, _ = jax_pipeline.load_images(str(tmp_path), 50)
    for a, b in zip(small, small_ref):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------- cluster segmenter

def cluster_image(h: int = 64, w: int = 96) -> np.ndarray:
    """tests/test_preprocess.py's two-region image with an object."""
    rng = np.random.default_rng(0)
    img = np.zeros((h, w, 3), np.uint8)
    img[:, :w // 2] = [200, 40, 40]
    img[:, w // 2:] = [40, 40, 200]
    img[20:40, 30:60] = [40, 200, 40]
    return np.clip(img.astype(np.int32) + rng.integers(-8, 8, img.shape),
                   0, 255).astype(np.uint8)


def test_connected_components_in_cv2_order():
    rng = np.random.default_rng(6)
    for h, w, p in ((64, 96, 0.5), (97, 131, 0.45), (33, 7, 0.5)):
        m = (rng.uniform(size=(h, w)) < p).astype(np.uint8)
        n, lab = port_pipeline.connected_components(m.astype(bool))
        n_ref, ref = cv2.connectedComponents(m)
        assert n == n_ref
        np.testing.assert_array_equal(lab, ref)
    n, lab = port_pipeline.connected_components(np.zeros((5, 5), bool))
    assert n == 1 and not lab.any()
    # a crop at an odd origin keeps the image's 2x2 blocks
    m = np.zeros((40, 50), np.uint8)
    m[5:32, 7:44] = rng.uniform(size=(27, 37)) < 0.5
    n_ref, ref = cv2.connectedComponents(m)
    n, lab = port_pipeline.connected_components(m[5:32, 7:44].astype(bool),
                                                (5, 7), 50)
    assert n == n_ref
    np.testing.assert_array_equal(lab, ref[5:32, 7:44])


def port_kmeans(seed: int = 42):
    """A cv2.kmeans stand-in returning the port's k-means labels."""
    def kmeans(feats, k, best_labels, criteria, attempts, flags):
        assert criteria[1:] == (10, 1.0) and attempts == 1
        gen = torch.Generator().manual_seed(seed)
        comp, labels, centers = port_pipeline.kmeans(
            torch.from_numpy(feats), k, gen)
        return comp, labels.numpy().astype(np.int32)[:, None], \
            centers.numpy()
    return kmeans


def test_cluster_masks_equal_jax_on_the_same_labels(monkeypatch):
    img = cluster_image()
    monkeypatch.setattr(cv2, "kmeans", port_kmeans())
    got = port_pipeline.ClusterMaskGenerator(device="cpu")(img)
    ref = jax_pipeline.ClusterMaskGenerator()(img)
    assert [len(x) for x in got] == [len(x) for x in ref]
    assert all(len(x) > 0 for x in got)
    for a, b in zip(got, ref):
        for m, r in zip(a, b):
            assert m["bbox"] == r["bbox"]
            np.testing.assert_array_equal(m["segmentation"],
                                          r["segmentation"])
    # a noise image too small for any cluster: the full-frame fallback
    tiny = np.random.default_rng(1).integers(0, 256, (6, 6, 3), np.uint8)
    got = port_pipeline.ClusterMaskGenerator(device="cpu")(tiny)
    assert [len(x) for x in got] == [1, 1, 1, 1]
    assert got[0][0]["bbox"] == [0, 0, 6, 6]


def test_kmeans_objective_near_cv2():
    gen = port_pipeline.ClusterMaskGenerator(device="cpu")
    for img in (cluster_image(), cluster_image(90, 120)[::-1].copy()):
        feats = gen.features(img)
        for k in (6, 16, 24):
            cv2.setRNGSeed(42)
            ref, _, _ = cv2.kmeans(
                feats.numpy(), k, None,
                (cv2.TERM_CRITERIA_EPS + cv2.TERM_CRITERIA_MAX_ITER, 10, 1.0),
                1, cv2.KMEANS_PP_CENTERS)
            comp, labels, centers = port_pipeline.kmeans(
                feats, k, torch.Generator().manual_seed(42))
            assert comp <= 1.10 * ref, (k, comp, ref)
            assert comp == pytest.approx(float(
                ((feats - centers[labels]) ** 2).sum()))


def test_cluster_pipeline_reads_back(tmp_path):
    img = cluster_image()
    pipe = port_pipeline.PreprocessPipeline(
        port_pipeline.ClusterMaskGenerator(device="cpu"), "hash",
        device="cpu")
    pipe.run([img], ["img_001.png"], str(tmp_path))
    seg = np.load(tmp_path / "img_001_s.npy")
    feats = np.load(tmp_path / "img_001_f.npy")
    assert seg.shape == (4, 64, 96) and seg.max() == feats.shape[0] - 1
    np.testing.assert_allclose(np.linalg.norm(feats, axis=1), 1.0, atol=1e-5)
    cam = Camera(0, np.eye(3), np.zeros(3), 1.0, 0.8,
                 np.zeros((3, 64, 96), np.float32), "img_001", 0)
    table, seg1 = cam.get_language_feature_compact(str(tmp_path), 1)
    np.testing.assert_array_equal(table, feats)
    np.testing.assert_array_equal(seg1, seg[1])


# ------------------------------------------------------------ command lines

def test_cli_equals_script(tmp_path, monkeypatch):
    rng = np.random.default_rng(9)
    imgs = {"a.png": cluster_image(), "b.png": np.ascontiguousarray(
        cluster_image(70, 50)[:, ::-1]),
        "c.png": rng.integers(0, 256, (1200, 90, 3), dtype=np.uint8)}
    for d in ("jax", "port"):
        write_pngs(tmp_path / d, imgs)
    monkeypatch.setattr(cv2, "kmeans", port_kmeans())
    run_script("preprocess", ["--dataset_path", str(tmp_path / "jax"),
                              "--mask_backend", "cluster",
                              "--clip_backend", "hash",
                              "--resolution", "100"], monkeypatch)
    out = io.StringIO()
    with redirect_stdout(out):
        summary = cli.main(["--dataset_path", str(tmp_path / "port"),
                            "--mask_backend", "auto", "--clip_backend",
                            "hash", "--resolution", "100",
                            "--sam_ckpt", str(tmp_path / "none.pth"),
                            "--device", "cpu"])
    assert "using the cluster fallback segmenter" in out.getvalue()
    assert summary["mask_backend"] == "cluster"
    assert summary["images"] == ["a.png", "b.png", "c.png"]
    assert_same_files(tmp_path / "jax" / "language_features",
                      tmp_path / "port" / "language_features",
                      ["a", "b", "c"])
    assert np.load(tmp_path / "port" / "language_features" / "c_s.npy") \
        .shape == (4, 100, round(90 * 100 / 1200))


def test_cli_wants_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--dataset_path", str(tmp_path), "--mask_backend",
                  "cluster"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_pipeline.ClusterMaskGenerator()
    help_text = io.StringIO()
    with redirect_stdout(help_text), pytest.raises(SystemExit):
        cli.main(["--help"])
    assert "torch SAM" in help_text.getvalue()


def fake_tools(bin_dir: Path, log: Path) -> None:
    """colmap and magick stand-ins that log their argv; colmap's
    image_undistorter writes <output>/sparse/ as COLMAP does."""
    bin_dir.mkdir()
    body = (f"#!{sys.executable}\n"
            "import os, sys\n"
            f"open({str(log)!r}, 'a').write(' '.join(\n"
            "    [os.path.basename(sys.argv[0])] + sys.argv[1:]) + '\\n')\n"
            "if sys.argv[1] == 'image_undistorter':\n"
            "    out = sys.argv[sys.argv.index('--output_path') + 1]\n"
            "    os.makedirs(os.path.join(out, 'sparse'), exist_ok=True)\n"
            "    open(os.path.join(out, 'sparse', 'cameras.bin'), 'w')\n"
            "    os.makedirs(os.path.join(out, 'images'), exist_ok=True)\n"
            "    open(os.path.join(out, 'images', 'x.jpg'), 'w')\n")
    for name in ("colmap", "magick"):
        p = bin_dir / name
        p.write_text(body)
        p.chmod(p.stat().st_mode | stat.S_IEXEC)


@pytest.mark.parametrize("flags", [[], ["--resize", "--no_gpu",
                                        "--skip_matching"]])
def test_convert_runs_the_scripts_commands(tmp_path, monkeypatch, flags):
    log = tmp_path / "log.txt"
    fake_tools(tmp_path / "bin", log)
    monkeypatch.setenv("PATH", f"{tmp_path / 'bin'}{os.pathsep}"
                       f"{os.environ['PATH']}")
    src = tmp_path / "scene"
    runs = []
    for run in ("script", "port"):
        if src.exists():
            import shutil
            shutil.rmtree(src)
        (src / "input").mkdir(parents=True)
        log.write_text("")
        argv = ["-s", str(src), *flags]
        if run == "script":
            run_script("convert", argv, monkeypatch)
        else:
            with redirect_stdout(io.StringIO()):
                convert.main(argv)
        runs.append((log.read_text(),
                     sorted(p.relative_to(src).as_posix()
                            for p in src.rglob("*"))))
    assert runs[0] == runs[1]
    assert "image_undistorter" in runs[0][0]
    assert ("mogrify -resize 50%" in runs[0][0]) == ("--resize" in flags)


def test_inspect_features_equals_script(tmp_path, monkeypatch):
    from langsplatv2_tpu.eval.openclip import OpenCLIPNetwork as JaxClip

    img = cluster_image()
    jax_pipeline.PreprocessPipeline(synthetic_generator, "hash").run(
        [img], ["f.png"], str(tmp_path))
    res = inspect_features.main([
        "--lf_path", str(tmp_path), "--image_name", "f", "--prompt",
        "a chair", "--output", str(tmp_path / "port.png"), "--device",
        "cpu"])
    seg = np.load(tmp_path / "f_s.npy")
    feats = np.load(tmp_path / "f_f.npy")
    text = np.asarray(JaxClip(backend="hash").encode_text(["a chair"]))
    text = text / np.linalg.norm(text, axis=-1, keepdims=True)
    for lvl in range(4):
        sim = np.zeros(seg[lvl].shape, np.float32)
        valid = seg[lvl] >= 0
        sim[valid] = feats[seg[lvl][valid]] @ text[0]
        np.testing.assert_array_equal(res["sims"][lvl], sim)
    np.testing.assert_array_equal(res["seg"], seg)
    assert res["figure"] and (tmp_path / "port.png").exists()
    out = run_script("inspect_features", [
        "--lf_path", str(tmp_path), "--image_name", "f", "--prompt",
        "a chair", "--output", str(tmp_path / "script.png"),
        "--clip_backend", "hash"], monkeypatch)
    assert "saved" in out and (tmp_path / "script.png").exists()


# ------------------------------------------------------------ CLIP devices

class RecordingModel(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.lin = torch.nn.Linear(3, 4)
        self.moved_to = []

    def to(self, *args, **kwargs):
        self.moved_to.append(torch.device(args[0]))
        return super().to(*args, **kwargs)

    def encode_image(self, x):
        assert x.device == self.lin.weight.device
        return x.mean(dim=(2, 3)) @ self.lin.weight.T

    def encode_text(self, tok):
        assert tok.device == self.lin.weight.device
        return tok.float()


def test_clip_backends_run_on_their_device(monkeypatch):
    """The repaired encoders place the model (and their inputs) on the
    device they are given; without CUDA the default raises."""
    model = RecordingModel()
    fake = types.SimpleNamespace(
        create_model_and_transforms=lambda *a, **k: (model, None, None),
        get_tokenizer=lambda name: lambda p: torch.ones(1, 4))
    monkeypatch.setitem(sys.modules, "open_clip", fake)
    backend = openclip.make_backend("open_clip", device="cpu")
    assert backend.device == torch.device("cpu")
    assert model.moved_to == [torch.device("cpu")]
    out = backend.encode_image(torch.rand(2, 3, 8, 8))
    assert out.shape == (2, 4)
    assert backend.encode_text(["a", "b"]).shape == (2, 4)
    net = openclip.OpenCLIPNetwork("open_clip", device="cpu")
    assert net.backend.device == torch.device("cpu")

    tf_model = RecordingModel()
    tb = openclip.TransformersBackend(model=tf_model, processor=object(),
                                      device="cpu")
    assert tb.device == torch.device("cpu")
    assert tf_model.moved_to == [torch.device("cpu")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        openclip.TransformersBackend(model=tf_model, processor=object())
    assert openclip.make_backend("auto").name == "hash"
