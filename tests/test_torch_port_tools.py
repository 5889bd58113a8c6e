"""The port's render tools (`langsplatv2_tpu_torch/tools/`) against what
scripts/demo_prompt.py, scripts/debug_renderer.py and
scripts/simple_viser.py compute, rebuilt from the JAX package (jitted; the
scripts' own drawing goes through cv2 and matplotlib): the heatmap frames,
the RGB and similarity panels, the splat arrays. The tools run as their
`main` on a tiny COLMAP scene and level checkpoints written by the port.
"""
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from langsplatv2_tpu.eval import lerf as jax_lerf
from langsplatv2_tpu.eval.openclip import OpenCLIPNetwork as JaxClip
from langsplatv2_tpu.models import io as jax_io
from langsplatv2_tpu.models.renderer import make_settings as jax_settings
from langsplatv2_tpu.models.renderer import render as jax_render
from langsplatv2_tpu.scene.scene import Scene as JaxScene
from langsplatv2_tpu.utils import transforms as jax_tf
from langsplatv2_tpu.utils.sh import sh_to_rgb
from langsplatv2_tpu_torch.eval.colormaps import jet_table
from langsplatv2_tpu_torch.models import gaussians as gm
from langsplatv2_tpu_torch.models import io
from langsplatv2_tpu_torch.scene.scene import Scene
from langsplatv2_tpu_torch.tools import debug_renderer, demo_prompt, \
    simple_viser
from torch_port_fixtures import write_colmap_scene

ITER = 10


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A 4-camera scene and three level checkpoints (16 codes each) of
    the scene's points."""
    root = tmp_path_factory.mktemp("tools")
    write_colmap_scene(root / "scene", np.random.default_rng(0), n_imgs=4,
                       n_pts=80)
    sc = Scene(str(root / "scene"), "", shuffle=False)
    base = gm.create_from_pcd(np.asarray(sc.points, np.float32),
                              np.asarray(sc.colors, np.float32), 1.0,
                              device="cpu")
    dirs = []
    for lvl in range(3):
        m = gm.init_language_features(
            base, 1, 16, generator=torch.Generator().manual_seed(lvl))
        d = root / f"m_{lvl + 1}"
        io.save_checkpoint(str(d / f"chkpnt{ITER}.npz"), m, None, ITER)
        dirs.append(str(d))
    return dict(root=root, src=str(root / "scene"), dirs=dirs)


def test_jet_table_is_opencv_jet():
    lut = cv2.applyColorMap(np.arange(256, dtype=np.uint8)[:, None],
                            cv2.COLORMAP_JET)[:, 0, ::-1]
    np.testing.assert_array_equal(jet_table(), lut)


def _jax_pose(cam):
    return tuple(jnp.asarray(np.asarray(x, np.float32)) for x in (
        cam.world_view_transform, cam.full_proj_transform,
        cam.camera_center))


def test_demo_prompt_matches_the_script(trained):
    """Every 2nd camera: the frames the port writes against the script's
    arithmetic on JAX's renders (its RGB render, the quick map's level
    sum, sim**4 over threshold**4, cv2's JET blended at 0.6), within one u8
    level of the RGB (three where the similarity's u8 step flips); the
    contrast-boosted similarity atol 1e-4."""
    out_dir = trained["root"] / "demo"
    paths = demo_prompt.main([
        "--ckpt_paths", *trained["dirs"], "--iteration", str(ITER),
        "--source_path", trained["src"], "--prompt", "a lamp",
        "--threshold", "0.05", "--every", "2", "--output_dir", str(out_dir),
        "--device", "cpu"])
    assert [os.path.basename(p) for p in paths] == ["frame_0000.png",
                                                    "frame_0001.png"]
    models = [jax_io.load_checkpoint_auto(
        jax_io.resolve_checkpoint(d, ITER))[0] for d in trained["dirs"]]
    merged = jax_lerf.merge_level_models(models, topk=4)
    cams = JaxScene(trained["src"], "", shuffle=False).get_train_cameras()
    text = np.asarray(JaxClip(backend="hash").encode_text(["a lamp"]))
    text = text / np.linalg.norm(text, axis=-1, keepdims=True)
    bg = jnp.zeros(3, jnp.float32)
    port_cams = Scene(trained["src"], "", shuffle=False).get_train_cameras()
    # One intrinsics for all cameras. The quick map through JAX's XLA route
    # (its Pallas kernel's result at 1e-5, without interpret mode's cost).
    s = jax_settings(cams[0], merged.active_sh_degree)
    render_rgb = jax.jit(
        lambda m, v, p, c: jax_render(s, m, v, p, c, bg).render)
    render_lf = jax.jit(
        lambda m, v, p, c: jax_lerf.render_language_feature_map_quick(
            m, s._replace(impl="xla"), v, p, c, bg))
    for i, cam in enumerate(cams[::2]):
        rgb = np.clip(np.asarray(render_rgb(merged, *_jax_pose(cam))
                                 ).transpose(1, 2, 0), 0, 1)
        lf = np.asarray(render_lf(merged, *_jax_pose(cam)))
        lf_sum = lf.sum(axis=0)
        lf_sum = lf_sum / (np.linalg.norm(lf_sum, axis=0, keepdims=True)
                           + 1e-10)
        sim = np.clip(np.einsum("dhw,d->hw", lf_sum, text[0]), 0, 1) ** 4
        sim = np.where(sim > 0.05 ** 4, sim, 0.0)
        if sim.max() > 0:
            sim = sim / sim.max()
        heat = cv2.applyColorMap((sim * 255).astype(np.uint8),
                                 cv2.COLORMAP_JET)
        heat = cv2.cvtColor(heat, cv2.COLOR_BGR2RGB) / 255.0
        frame = (np.where(sim[..., None] > 0, rgb * 0.4 + heat * 0.6, rgb)
                 * 255).astype(np.uint8)
        got = np.asarray(Image.open(paths[i]))
        assert got.shape == frame.shape
        # A sim one u8 step apart moves the JET colour 4 levels, 2.4 after
        # the 0.6 blend.
        assert np.abs(got.astype(int) - frame).max() <= 3
        mine = demo_prompt.heatmap_frame(
            demo_prompt.merge_level_models(
                [io.load_checkpoint(io.resolve_checkpoint(d, ITER),
                                    device="cpu")[0]
                 for d in trained["dirs"]], topk=4),
            port_cams[::2][i], text[0], 0.05, device="cpu")
        np.testing.assert_allclose(mine["sim"], sim, atol=1e-4)
        np.testing.assert_array_equal(mine["frame"], got)
        assert (sim > 0).any()


def test_debug_renderer_matches_the_script(trained):
    """The RGB panel and the per-prompt similarities against the script's
    arrays from JAX's renders (RGB, then the top-4 feature render decoded
    and normalized), atol 1e-5; the logit statistics; the sheet is
    written."""
    ckpt = os.path.join(trained["dirs"][0], f"chkpnt{ITER}.npz")
    out = str(trained["root"] / "debug.png")
    prompts = ["car", "tree"]
    res = debug_renderer.main(["--checkpoint", ckpt, "--source_path",
                               trained["src"], "--prompts", *prompts,
                               "--output", out, "--device", "cpu"])
    sheet = Image.open(out)
    assert sheet.size[0] == 3 * 64 and res["iteration"] == ITER
    model, _ = jax_io.load_checkpoint_auto(ckpt)
    logits = np.asarray(model.language_logits)
    np.testing.assert_allclose(
        [res["logit_stats"][k] for k in ("mean", "std", "min", "max")],
        [logits.mean(), logits.std(), logits.min(), logits.max()],
        rtol=1e-5)
    cam = JaxScene(trained["src"], "", shuffle=False).get_train_cameras()[0]
    s = jax_settings(cam, model.active_sh_degree)
    bg = jnp.zeros(3, jnp.float32)
    rgb = np.clip(np.asarray(jax.jit(
        lambda m, v, p, c: jax_render(s, m, v, p, c, bg).render)(
            model, *_jax_pose(cam))).transpose(1, 2, 0), 0, 1)
    wmap = jax.jit(lambda m, v, p, c: jax_render(
        s, m, v, p, c, bg, include_feature=True,
        topk=4).language_feature_weight_map)(model, *_jax_pose(cam))
    feat = np.asarray(model.compute_final_feature_map(wmap))
    feat = feat / (np.linalg.norm(feat, axis=0, keepdims=True) + 1e-10)
    text = np.asarray(JaxClip(backend="hash").encode_text(prompts))
    text = text / np.linalg.norm(text, axis=-1, keepdims=True)
    sims = np.einsum("dhw,pd->hwp", feat, text)
    np.testing.assert_allclose(res["panels"]["rgb"], rgb, atol=1e-5)
    np.testing.assert_allclose(res["panels"]["sims"], sims, atol=1e-5)


def test_simple_viser_arrays_match_the_script(trained, capsys):
    """The splat arrays of a PLY against the script's (sh_to_rgb of the DC
    colour, the sigmoid opacities, unstrip_symmetric of the covariances);
    without viser the tool prints so and exits with status 1."""
    model, _ = io.load_checkpoint(
        os.path.join(trained["dirs"][0], f"chkpnt{ITER}.npz"), device="cpu")
    ply = str(trained["root"] / "splats.ply")
    io.save_ply(model, ply)
    mine = simple_viser.splat_arrays(io.load_ply(ply, 3, device="cpu"))
    ref_model = jax_io.load_ply(ply, max_sh_degree=3)
    ref = dict(
        centers=np.asarray(ref_model.xyz),
        rgbs=np.clip(np.asarray(sh_to_rgb(ref_model.features_dc[:, 0])),
                     0, 1),
        opacities=np.asarray(jax_tf.opacity_activation(ref_model.opacity)),
        covariances=np.asarray(jax_tf.unstrip_symmetric(
            ref_model.get_covariance())))
    assert mine.keys() == ref.keys()
    for k, v in ref.items():
        assert mine[k].shape == v.shape, k
        np.testing.assert_allclose(mine[k], v, rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    try:
        import viser  # noqa: F401
    except ImportError:
        with pytest.raises(SystemExit) as e:
            simple_viser.main(["--ply_path", ply])
        assert e.value.code == 1
        assert "viser is not installed" in capsys.readouterr().out
