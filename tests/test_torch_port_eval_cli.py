"""The port's benchmark command lines against the JAX scripts, in process
(no subprocess): `python -m langsplatv2_tpu_torch.eval.{eval_lerf,
eval_3d_ovs,eval_mip_nerf360,eval_psnr} --device cpu` return the dict whose
JSON the script prints, and it equals the JSON line that
scripts/eval_{lerf,3d_ovs,mip_nerf360,psnr}.py prints for the same argv
(the script's main under a patched sys.argv) to 1e-6 on every number, the
counts equal.

The inputs: a COLMAP scene of three cameras from
`torch_port_fixtures.write_colmap_scene` with a labelme `label/` for its
second camera (rectangles, a concave and a self-intersecting polygon,
vertices outside the frame) and a `segmentations/` folder for its third
(the JAX package takes seconds a frame on the CPU, so one each); three
level checkpoints written by JAX's `save_checkpoint`, so that both
packages read the same files, and a second root whose level 2 is a
reference `.pth` written by the port's interop; two geometry checkpoints
for the PSNR command line, and a Blender scene without a test split.
"""
import importlib.util
import io
import json
import os
import sys
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

from langsplatv2_tpu.models import gaussians as jgm
from langsplatv2_tpu.models import io as jax_io
from langsplatv2_tpu_torch.eval import (eval_3d_ovs, eval_lerf,
                                        eval_mip_nerf360, eval_psnr)
from langsplatv2_tpu_torch.models import io as port_io
from langsplatv2_tpu_torch.models.torch_interop import save_torch_checkpoint
from langsplatv2_tpu_torch.scene.dataset import store_point_cloud_ply

from torch_port_fixtures import write_colmap_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 48, 64
SCENE = "bench"
ITER = 10


def _script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_script(name: str, argv: list, monkeypatch) -> tuple[dict, str]:
    """scripts/<name>.py's main on argv: (its last line as JSON, stdout)."""
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    out = io.StringIO()
    with redirect_stdout(out):
        _script(name).main()
    return json.loads(out.getvalue().strip().splitlines()[-1]), out.getvalue()


def run_port(module, argv: list) -> tuple[dict, str]:
    out = io.StringIO()
    with redirect_stdout(out):
        summary = module.main([*argv, "--device", "cpu"])
    assert json.loads(out.getvalue().strip().splitlines()[-1]) == summary
    return summary, out.getvalue()


def assert_same(port: dict, ref: dict):
    assert port.keys() == ref.keys()
    for k, v in ref.items():
        if isinstance(v, int):
            assert port[k] == v, k
        else:
            np.testing.assert_allclose(port[k], v, atol=1e-6, rtol=0,
                                       err_msg=k)


def _labelme(scene, frames):
    """A labelme file a frame (frame_<j + 1>.json is camera j's GT)."""
    label = scene / "label"
    label.mkdir()
    rng = np.random.default_rng(11)
    for j in frames:
        objects = []
        for name in ("cup", "plate", "book"):
            x0, y0 = int(rng.integers(-4, W // 2)), int(rng.integers(-4,
                                                                     H // 2))
            x1, y1 = x0 + int(rng.integers(8, 30)), y0 + int(rng.integers(6,
                                                                          24))
            objects.append({"category": name, "bbox": [x0, y0, x1, y1],
                            "segmentation": [[x0, y0], [x1, y0], [x1, y1],
                                             [x0, y1]]})
        objects.append({"category": "plate", "bbox": [30, 20, 60, 46],
                        "segmentation": [[30, 20], [60, 20], [44, 30],
                                         [60, 46], [30, 46]]})
        objects.append({"category": "lamp", "bbox": [5, 25, 40, 50],
                        "segmentation": [[5.5, 25], [40, 50.2], [40, 25],
                                         [5, 50]]})
        name = f"frame_{j + 1:05d}.jpg"
        with open(label / name.replace(".jpg", ".json"), "w") as f:
            json.dump({"info": {"name": name, "height": H, "width": W},
                       "objects": objects}, f)


def _segmentations(scene):
    rng = np.random.default_rng(12)
    for fid in ("img_003",):
        d = scene / "segmentations" / fid
        d.mkdir(parents=True)
        for p in ("chair", "lamp", "wood wall"):
            m = np.zeros((H, W), np.uint8)
            y0, x0 = rng.integers(0, H // 2), rng.integers(0, W // 2)
            m[y0:y0 + H // 3, x0:x0 + W // 3] = 255
            Image.fromarray(m).save(d / f"{p}.png")


def _jax_level_models(points):
    n = points.shape[0]
    models = []
    for lvl in range(3):
        m = jgm.create_from_pcd(points, np.full((n, 3), 0.5, np.float32),
                                1.0)
        m = m.replace(opacity=jnp.full((n, 1), 1.5))
        models.append(jgm.init_language_features(
            m, jax.random.PRNGKey(lvl + 3), 1, 64))
    return models


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval_cli")
    rng = np.random.default_rng(0)
    scene = root / "data" / SCENE
    write_colmap_scene(scene, rng, n_imgs=3, n_pts=60, h=H, w=W)
    _labelme(scene, [1])
    _segmentations(scene)
    pts = np.concatenate([rng.uniform(-1, 1, (48, 2)),
                          rng.uniform(1.0, 3.0, (48, 1))], 1).astype(
                              np.float32)
    for lvl, m in enumerate(_jax_level_models(pts), start=1):
        jax_io.save_checkpoint(
            str(root / "ckpt" / f"{SCENE}_1_{lvl}" / f"chkpnt{ITER}.npz"),
            m, None, ITER)
        d = root / "ckpt_pth" / f"{SCENE}_1_{lvl}"
        d.mkdir(parents=True)
        src = root / "ckpt" / f"{SCENE}_1_{lvl}" / f"chkpnt{ITER}.npz"
        if lvl == 2:
            model, it = port_io.load_checkpoint(str(src), device="cpu")
            save_torch_checkpoint(str(d / f"chkpnt{ITER}.pth"), model, it)
        else:
            (d / src.name).write_bytes(src.read_bytes())
    geometry = jgm.create_from_pcd(pts, rng.uniform(0, 1, (48, 3)).astype(
        np.float32), 1.0)
    for it, op in ((3, 0.5), (7, 1.5)):
        jax_io.save_checkpoint(str(root / "geom" / f"chkpnt{it}.npz"),
                               geometry.replace(opacity=jnp.full((48, 1), op)),
                               None, it)
    return root


def _bench_argv(root, out: str, ckpt: str = "ckpt"):
    return ["--dataset_name", SCENE, "--path_root", str(root / "data"),
            "--ckpt_root", str(root / ckpt), "--output_root",
            str(root / out), "--iteration", str(ITER), "--clip_backend",
            "hash"]


@pytest.mark.parametrize("extra", [[], ["--no-quick"]],
                         ids=["quick", "no-quick"])
def test_eval_lerf_matches_script(bench, monkeypatch, extra):
    port, _ = run_port(eval_lerf, _bench_argv(bench, "port") + extra)
    ref, _ = run_script("eval_lerf", _bench_argv(bench, "jax") + extra,
                        monkeypatch)
    assert_same(port, ref)
    assert os.path.exists(bench / "port" / SCENE / "gt" / "frame_00002" /
                          "lamp.jpg")


@pytest.mark.parametrize("extra", [[], ["--no-quick"]],
                         ids=["quick", "no-quick"])
def test_eval_lerf_reads_a_pth_level(bench, extra):
    """Level 2 as a reference .pth (resolve_checkpoint's fallback) scores
    as its .npz does (which the test above holds to the script's)."""
    pth, _ = run_port(eval_lerf, _bench_argv(bench, "port", "ckpt_pth")
                      + extra)
    npz, _ = run_port(eval_lerf, _bench_argv(bench, "port") + extra)
    assert_same(pth, npz)


@pytest.mark.parametrize("module,script", [
    (eval_3d_ovs, "eval_3d_ovs"), (eval_mip_nerf360, "eval_mip_nerf360")],
    ids=["3d_ovs", "mip_nerf360"])
def test_benchmark_cli_matches_script(bench, monkeypatch, module, script):
    port, _ = run_port(module, _bench_argv(bench, "port"))
    ref, _ = run_script(script, _bench_argv(bench, "jax"), monkeypatch)
    assert_same(port, ref)
    assert port["num_prompts"] == (3 if script == "eval_3d_ovs" else 4)


def _lines(stdout: str):
    """The per-image lines as (name, PSNR) and the average."""
    images = [(ln.split()[1].rstrip(":"), float(ln.rsplit("=", 1)[1]))
              for ln in stdout.splitlines() if ln.startswith("Image ")]
    avg = [float(ln.split(":")[1]) for ln in stdout.splitlines()
           if ln.startswith("Average PSNR")]
    return images, avg


def _compare_psnr(port_out, ref_out):
    (pi, pa), (ri, ra) = _lines(port_out), _lines(ref_out)
    assert [n for n, _ in pi] == [n for n, _ in ri] and len(pa) == 1
    np.testing.assert_allclose([v for _, v in pi] + pa,
                               [v for _, v in ri] + ra, atol=1e-4)


def test_eval_psnr_latest_checkpoint_matches_script(bench, monkeypatch):
    """--iteration -1 takes chkpnt7.npz, the higher of 3 and 7; the COLMAP
    scene's test split (every 8th camera) holds its first camera."""
    argv = ["-s", str(bench / "data" / SCENE), "-m", str(bench / "geom"),
            "--white_background"]
    port, port_out = run_port(eval_psnr, argv)
    ref, ref_out = run_script("eval_psnr", argv, monkeypatch)
    assert_same(port, ref)
    assert port["num_images"] == 1
    assert "chkpnt7.npz" in port_out.splitlines()[0]
    _compare_psnr(port_out, ref_out)


def _blender_scene(root):
    """A NeRF-synthetic scene of 12 frames with no transforms_test.json."""
    scene = root / "blender"
    if scene.exists():
        return scene
    (scene / "train").mkdir(parents=True)
    rng = np.random.default_rng(4)
    frames = []
    for i in range(12):
        c2w = np.eye(4)
        c2w[:3, 3] = [0.05 * i, 0.0, 4.5]
        frames.append({"file_path": f"./train/r_{i}",
                       "transform_matrix": c2w.tolist()})
        Image.fromarray((rng.uniform(size=(H, W, 3)) * 255).astype(
            np.uint8)).save(scene / "train" / f"r_{i}.png")
    with open(scene / "transforms_train.json", "w") as f:
        json.dump({"camera_angle_x": 0.9, "frames": frames}, f)
    store_point_cloud_ply(str(scene / "points3d.ply"),
                          rng.uniform(-1, 1, (20, 3)),
                          rng.uniform(0, 1, (20, 3)))
    return scene


def test_eval_psnr_without_test_split_matches_script(bench, monkeypatch):
    """A scene without a test split scores its first 10 training cameras
    (scripts/eval_psnr.py:46-49), of which --limit keeps the first 3: the
    port's 10 lines begin with the script's 3 (the JAX package renders a
    frame in seconds on the CPU, so the script runs with the limit)."""
    argv = ["-s", str(_blender_scene(bench)), "-m", str(bench / "geom"),
            "--iteration", "3"]
    port, port_out = run_port(eval_psnr, argv + ["--limit", "3"])
    ref, ref_out = run_script("eval_psnr", argv + ["--limit", "3"],
                              monkeypatch)
    assert_same(port, ref)
    assert port["num_images"] == 3
    assert "No test cameras found" in port_out
    _compare_psnr(port_out, ref_out)
    every, every_out = run_port(eval_psnr, argv)
    assert every["num_images"] == 10
    names = [n for n, _ in _lines(every_out)[0]]
    assert names == [f"r_{i}" for i in range(10)]
    assert _lines(every_out)[0][:3] == _lines(port_out)[0]
