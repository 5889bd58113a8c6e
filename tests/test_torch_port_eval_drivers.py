"""The other eval drivers and helpers, port against JAX: 3D-OVS and
Mip-NeRF360 (`evaluate_quick`, the room variant, GT folders,
`resize_feature_map`), `evaluate_psnr`, colormaps, LPIPS (VGG and AlexNet
trunks carrying JAX's `random_params`) and the transformers CLIP backend
on a small random CLIPConfig (never from_pretrained). Inputs are numpy
arrays from a seed handed to both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from langsplatv2_tpu.eval import colormaps as jcmap
from langsplatv2_tpu.eval import lerf as jlerf
from langsplatv2_tpu.eval import lpips as jlpips
from langsplatv2_tpu.eval import mip360 as jmip
from langsplatv2_tpu.eval import ovs as jovs
from langsplatv2_tpu.eval import psnr_eval as jpsnr
from langsplatv2_tpu.eval.openclip import OpenCLIPNetwork as JaxNetwork
from langsplatv2_tpu.eval.openclip import \
    TransformersBackend as JaxTransformersBackend
from langsplatv2_tpu.models import gaussians as jgm
from langsplatv2_tpu.models import io as jax_io
from langsplatv2_tpu_torch.eval import colormaps, lerf, lpips, mip360, ovs, \
    psnr_eval
from langsplatv2_tpu_torch.eval.openclip import (OpenCLIPNetwork,
                                                 TransformersBackend,
                                                 make_backend)
from langsplatv2_tpu_torch.models import gaussians as gm

from scene_fixtures import make_camera, random_gaussians

H, W = 48, 64


class FakeCam:
    def __init__(self, cam, image=None):
        self.world_view_transform = np.asarray(cam["viewmatrix"])
        self.full_proj_transform = np.asarray(cam["projmatrix"])
        self.camera_center = np.asarray(cam["campos"])
        self.tanfovx, self.tanfovy = cam["tanfovx"], cam["tanfovy"]
        self.image_height, self.image_width = H, W
        self.image = image


def _port_model(jm):
    fields = {k: np.asarray(getattr(jm, k)) for k in jax_io.MODEL_FIELDS
              if getattr(jm, k) is not None}
    return gm.from_numpy_params(fields, active_sh_degree=jm.active_sh_degree,
                                max_sh_degree=jm.max_sh_degree,
                                device="cpu")


@pytest.fixture(scope="module")
def merged():
    """tests/test_eval.py's merged 3-level model of 40 splats, both
    packages, and a camera off the world origin."""
    rng = np.random.default_rng(1)
    n = 40
    g = random_gaussians(rng, n)
    jmodels = []
    for lvl in range(3):
        m = jgm.create_from_pcd(np.asarray(g["means3d"]),
                                rng.uniform(0, 1, (n, 3)).astype(np.float32),
                                1.0)
        m = m.replace(opacity=jnp.full((n, 1), 1.5))
        jmodels.append(jgm.init_language_features(
            m, jax.random.PRNGKey(lvl + 5), 1, 64))
    jm = jlerf.merge_level_models(jmodels)
    cam = FakeCam(make_camera(H, W, t=np.array([0.1, -0.05, 0.2])))
    return dict(jm=jm, m=lerf.merge_level_models(
        [_port_model(x) for x in jmodels]), jmodels=jmodels, cam=cam)


def _masks(h, w, n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        m = np.zeros((h, w), np.uint8)
        y0, x0 = rng.integers(0, h // 2), rng.integers(0, w // 2)
        m[y0:y0 + h // 3, x0:x0 + w // 3] = 1
        out.append(m)
    return out


def _nets():
    return OpenCLIPNetwork(device="cpu"), JaxNetwork(backend="hash")


@pytest.mark.parametrize("scene_name,gram", [("", True), ("room", False)])
def test_ovs_evaluate_quick_matches_jax(merged, scene_name, gram):
    """The Gram route on the plain scene, the decode route on the room
    variant (two prompts scored, level 0 never chosen)."""
    prompts = ["chair", "lamp", "table", "wood wall"]
    gt_ann = {"f0": {p: {"mask": m} for p, m in
                     zip(prompts, _masks(H, W, len(prompts), 3))}}
    cams = {"f0": merged["cam"]}
    net, jnet = _nets()
    out = ovs.evaluate_quick(merged["m"], cams, gt_ann, net,
                             scene_name=scene_name, gram_relevancy=gram,
                             device="cpu")
    ref = jovs.evaluate_quick(merged["jm"], cams, gt_ann, jnet,
                              scene_name=scene_name, gram_relevancy=gram)
    assert out["num_prompts"] == ref["num_prompts"] == (
        2 if scene_name == "room" else 4)
    np.testing.assert_allclose(out["mean_iou"], ref["mean_iou"], atol=1e-6)


def test_ovs_gt_folder_matches_jax(tmp_path):
    import cv2

    for fid, seed in (("00", 1), ("01", 2)):
        d = tmp_path / fid
        d.mkdir()
        for name, m in zip(("wood wall", "cup", "book"),
                           _masks(20, 24, 3, seed)):
            cv2.imwrite(str(d / f"{name}.png"),
                        np.repeat(m[..., None] * 255, 3, axis=2))
    (tmp_path / "notes.txt").write_text("skipped")
    out, ids = ovs.eval_gt_ovsdata(str(tmp_path))
    ref, ref_ids = jovs.eval_gt_ovsdata(str(tmp_path))
    assert ids == ref_ids == ["00", "01"]
    for fid in ids:
        assert list(out[fid]) == list(ref[fid])
        assert list(out[fid])[-1] == "wood wall"
        for p in out[fid]:
            np.testing.assert_array_equal(out[fid][p]["mask"],
                                          ref[fid][p]["mask"])


@pytest.mark.parametrize("size", [(48, 64), (12, 16), (17, 45), (40, 20)])
def test_resize_feature_map_matches_jax(size):
    """Up and down, per axis: the triangle filter widened when it shrinks
    (antialias) matches jax.image.resize(..., "bilinear") within 1e-6."""
    x = np.random.default_rng(0).normal(size=(2, 3, 24, 32)).astype(
        np.float32)
    out = mip360.resize_feature_map(torch.from_numpy(x), *size).numpy()
    ref = np.asarray(jmip.resize_feature_map(jnp.asarray(x), *size))
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)


def test_mip360_evaluate_quick_matches_jax(merged):
    gh, gw = 36, 40                      # GT below the render: a resize
    prompts = ["bench", "tree"]
    masks = _masks(gh, gw, 2, 8)
    gt_ann = {"0": {p: {"mask": m, "bboxes": np.array([4, 4, 30, 30])}
                    for p, m in zip(prompts, masks)}}
    net, jnet = _nets()
    out = mip360.evaluate_quick(merged["m"], [merged["cam"]], gt_ann,
                                (gh, gw), net, device="cpu")
    ref = jmip.evaluate_quick(merged["jm"], [merged["cam"]], gt_ann,
                              (gh, gw), jnet)
    assert out["num_prompts"] == ref["num_prompts"] == 2
    np.testing.assert_allclose(out["mean_iou"], ref["mean_iou"], atol=1e-6)
    assert out["localization_accuracy"] == ref["localization_accuracy"]


def test_evaluate_psnr_matches_jax(merged):
    img = np.random.default_rng(5).uniform(size=(3, H, W)).astype(np.float32)
    cam = merged["cam"]
    cams = [FakeCam(make_camera(H, W, t=np.array([0.1, -0.05, 0.2])), img)]
    mean, vals = psnr_eval.evaluate_psnr(merged["m"], cams, device="cpu")
    ref_mean, ref_vals = jpsnr.evaluate_psnr(merged["jm"], cams)
    assert cam.image is None and len(vals) == len(ref_vals) == 1
    assert abs(mean - ref_mean) <= 1e-4, (mean, ref_mean)


def test_colormaps_match_jax():
    rng = np.random.default_rng(0)
    img = rng.uniform(size=(8, 10, 1)).astype(np.float32)
    opts = colormaps.ColormapOptions(normalize=True, invert=True)
    jopts = jcmap.ColormapOptions(normalize=True, invert=True)
    np.testing.assert_array_equal(colormaps.apply_colormap(img, opts),
                                  jcmap.apply_colormap(img, jopts))
    for name in ("gray", "viridis", "default"):
        np.testing.assert_array_equal(
            colormaps.apply_float_colormap(img, name),
            jcmap.apply_float_colormap(img, name))
    mask = img > 0.5
    np.testing.assert_array_equal(colormaps.apply_colormap(mask),
                                  jcmap.apply_colormap(mask))
    acc = rng.uniform(size=(8, 10, 1)).astype(np.float32)
    np.testing.assert_array_equal(
        colormaps.apply_depth_colormap(img * 5, acc),
        jcmap.apply_depth_colormap(img * 5, acc))
    feats = rng.normal(size=(8, 10, 6)).astype(np.float32)
    feats[0, 0] = 0
    np.testing.assert_allclose(colormaps.apply_pca_colormap(feats),
                               jcmap.apply_pca_colormap(feats), atol=1e-6)


@pytest.mark.parametrize("net", ["vgg", "alex"])
def test_lpips_matches_jax(net):
    """The same random instance on 2 image pairs at 64x64: rtol 1e-4 (f32
    convolutions in another summation order)."""
    params = lpips.random_params(net, seed=3)
    jparams = jlpips.random_params(net, seed=3)
    for (w, b), (jw, jb) in zip(params["convs"], jparams["convs"]):
        np.testing.assert_array_equal(w, np.asarray(jw))
        np.testing.assert_array_equal(b, np.asarray(jb))
    rng = np.random.default_rng(4)
    a, b = (rng.uniform(size=(2, 3, 64, 64)).astype(np.float32)
            for _ in range(2))
    jp = {"convs": [(np.asarray(w), np.asarray(bb))
                    for w, bb in jparams["convs"]],
          "heads": [np.asarray(h) for h in jparams["heads"]]}
    out = lpips.lpips(jp, a, b, net, device="cpu").numpy()
    ref = np.asarray(jlpips.lpips(jparams, jnp.asarray(a), jnp.asarray(b),
                                  net=net))
    assert out.shape == (2,) and (out > 0).all()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=0)
    assert float(lpips.lpips(jp, a, a, net, device="cpu").abs().max()) < 1e-6


def test_lpips_state_dict_loader_matches_jax():
    params = lpips.random_params("alex", seed=1)
    trunk, conv_i = {}, 0
    for i, layer in enumerate(lpips._ALEX_CFG):
        if layer[0] == "pool":
            continue
        w, b = params["convs"][conv_i]
        trunk[f"{2 * i}.weight"], trunk[f"{2 * i}.bias"] = (
            torch.from_numpy(w), torch.from_numpy(b))
        conv_i += 1
    heads = {f"lins.{i}.model.1.weight":
             torch.from_numpy(h)[None, :, None, None]
             for i, h in enumerate(params["heads"])}
    out = lpips.load_torch_state_dict(trunk, heads, "alex")
    ref = jlpips.load_torch_state_dict(trunk, heads, "alex")
    for (w, b), (jw, jb) in zip(out["convs"], ref["convs"]):
        np.testing.assert_array_equal(w, np.asarray(jw))
        np.testing.assert_array_equal(b, np.asarray(jb))
    for h, jh in zip(out["heads"], ref["heads"]):
        np.testing.assert_array_equal(h, np.asarray(jh))


def _tiny_clip(tmp_path):
    """A random 2-layer CLIPModel with a byte-level vocabulary (no merges)
    and a 32 px image processor, written and read locally."""
    import json

    from transformers import (CLIPConfig, CLIPImageProcessor, CLIPModel,
                              CLIPProcessor, CLIPTokenizer)
    from transformers.models.clip.tokenization_clip import bytes_to_unicode

    chars = list(bytes_to_unicode().values())
    vocab = {t: i for i, t in enumerate(
        chars + [c + "</w>" for c in chars]
        + ["<|startoftext|>", "<|endoftext|>"])}
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "merges.txt").write_text("#version: 0.2\n")
    tok = CLIPTokenizer(str(tmp_path / "vocab.json"),
                        str(tmp_path / "merges.txt"))
    images = CLIPImageProcessor(size={"shortest_edge": 32},
                                crop_size={"height": 32, "width": 32})
    cfg = CLIPConfig(
        text_config=dict(vocab_size=len(vocab), hidden_size=32,
                         intermediate_size=37, num_hidden_layers=2,
                         num_attention_heads=4, max_position_embeddings=77,
                         bos_token_id=vocab["<|startoftext|>"],
                         eos_token_id=vocab["<|endoftext|>"]),
        vision_config=dict(image_size=32, patch_size=8, hidden_size=32,
                           intermediate_size=37, num_hidden_layers=2,
                           num_attention_heads=4),
        projection_dim=16)
    torch.manual_seed(0)
    model = CLIPModel(cfg).eval()
    return model, CLIPProcessor(image_processor=images, tokenizer=tok)


def test_transformers_backend_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("USE_TF", "0")     # transformers' TensorFlow import
    model, processor = _tiny_clip(tmp_path)
    port = TransformersBackend(model=model, processor=processor, device="cpu")
    ref = JaxTransformersBackend.__new__(JaxTransformersBackend)
    ref.model, ref.processor = model, processor
    texts = ["a red apple", "chair", "grass and sky"]
    out = port.encode_text(texts)
    assert out.shape == (3, 16)
    np.testing.assert_array_equal(out, ref.encode_text(texts))
    imgs = np.random.default_rng(0).uniform(size=(2, 3, 40, 48)).astype(
        np.float32)
    np.testing.assert_array_equal(port.encode_image(imgs),
                                  ref.encode_image(imgs))
    with pytest.raises(NotImplementedError, match="transformers"):
        make_backend("flax")
    assert make_backend().name == "hash"
