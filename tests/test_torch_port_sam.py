"""The port's SAM (langsplatv2_tpu_torch/preprocess/sam.py) against the
Flax SAM (langsplatv2_tpu/preprocess/sam_jax.py) at VIT_TINY_TEST, with
JAX's `init_params` carried across by `state_dict_from_jax_params`: the
image embedding (1e-5 of its largest), the mask logits (1e-4 of their
largest) and iou_pred (1e-5); the automatic generator on
tests/test_sam_jax.py's image and settings (the same masks a level, the
same boxes, stability within 1e-4 relative); the preprocess files of a
tiny SAM byte-equal to JAX's with the hash CLIP backend. An upstream-schema
state dict (tests/test_torch_parity.py's MiniSam, whose module tree is
segment_anything's) loads strict and gives upstream's forward.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from langsplatv2_tpu.preprocess import sam_jax
from langsplatv2_tpu.preprocess.pipeline import \
    PreprocessPipeline as JaxPipeline
from langsplatv2_tpu_torch.preprocess import sam
from langsplatv2_tpu_torch.preprocess.pipeline import PreprocessPipeline

CFG = sam_jax.VIT_TINY_TEST
GEN_SETTINGS = dict(points_per_side=4, points_per_batch=8,
                    pred_iou_thresh=-1e9, stability_score_thresh=0.0,
                    min_mask_region_area=1)


@pytest.fixture(scope="module")
def carried():
    params = sam_jax.init_params(CFG, jax.random.PRNGKey(0))
    model = sam.Sam(sam.VIT_TINY_TEST)
    model.load_state_dict(sam.state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, params), sam.VIT_TINY_TEST),
        strict=True)
    return params, model.eval()


def test_config_matches_jax():
    assert sam.VIT_H == sam.SamConfig()
    for cfg, ref in ((sam.VIT_H, sam_jax.VIT_H),
                     (sam.VIT_TINY_TEST, sam_jax.VIT_TINY_TEST)):
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)


def test_encoder_and_decoder_match_jax(carried):
    params, model = carried
    rng = np.random.default_rng(0)
    x = rng.standard_normal((CFG.img_size, CFG.img_size, 3)).astype(
        np.float32)
    ref = np.asarray(sam_jax.encode_image(CFG, params, jnp.asarray(x)))
    with torch.no_grad():
        emb = model.encode_image(torch.from_numpy(x)).numpy()
    assert emb.shape == (CFG.grid, CFG.grid, CFG.prompt_dim)
    assert np.abs(emb - ref).max() <= 1e-5 * np.abs(ref).max()

    pts = rng.uniform(size=(5, 1, 2)).astype(np.float32)
    labels = np.ones((5, 1), np.float32)
    ref_m, ref_i = sam_jax.decode_masks(CFG, params, jnp.asarray(ref),
                                        jnp.asarray(pts), jnp.asarray(labels))
    ref_m, ref_i = np.asarray(ref_m), np.asarray(ref_i)
    with torch.no_grad():
        m, i = model.decode_masks(torch.from_numpy(ref.copy()),
                                  torch.from_numpy(pts),
                                  torch.from_numpy(labels))
    assert m.shape == ref_m.shape == (5, 4, 4 * CFG.grid, 4 * CFG.grid)
    assert np.abs(m.numpy() - ref_m).max() <= 1e-4 * np.abs(ref_m).max()
    np.testing.assert_allclose(i.numpy(), ref_i, atol=1e-5, rtol=0)


def test_upstream_state_dict_loads_strict():
    """MiniSam's state_dict has segment_anything's keys (mask_downscaling
    included); the port loads it strict and reproduces its forward."""
    from test_torch_parity import MiniSam, torch_sam_forward

    mini = MiniSam(CFG)
    model = sam.Sam(sam.VIT_TINY_TEST)
    model.load_state_dict(mini.state_dict(), strict=True)
    assert set(model.state_dict()) == set(mini.state_dict())
    model.eval()
    rng = np.random.default_rng(1)
    img = rng.standard_normal((CFG.img_size, CFG.img_size, 3)).astype(
        np.float32)
    pts = rng.uniform(size=(3, 1, 2)).astype(np.float32)
    labels = np.ones((3, 1), np.float32)
    ref_e, ref_m, ref_i = torch_sam_forward(mini, CFG, img, pts, labels)
    with torch.no_grad():
        emb = model.encode_image(torch.from_numpy(img))
        m, i = model.decode_masks(emb, torch.from_numpy(pts),
                                  torch.from_numpy(labels))
    np.testing.assert_allclose(emb.numpy(), ref_e, atol=1e-5 * np.abs(
        ref_e).max(), rtol=0)
    np.testing.assert_allclose(m.numpy(), ref_m, atol=1e-4 * np.abs(
        ref_m).max(), rtol=0)
    np.testing.assert_allclose(i.numpy(), ref_i, atol=1e-5, rtol=0)


def test_checkpoint_file_and_init_weights(tmp_path):
    """`from_checkpoint` reads an upstream-keyed file; `init_weights`
    draws JAX's distribution from the generator (same seed, same
    weights)."""
    g = torch.Generator().manual_seed(3)
    model = sam.init_weights(sam.Sam(sam.VIT_TINY_TEST), g).requires_grad_(
        False)
    w = model.image_encoder.blocks[0].attn.qkv.weight
    assert abs(float(w.std()) - 0.02) < 0.004
    assert float(model.image_encoder.blocks[0].norm1.weight.min()) == 1.0
    assert float(model.mask_decoder.iou_prediction_head.layers[0].bias
                 .abs().max()) == 0.0
    path = tmp_path / "tiny_sam.pth"
    torch.save(model.state_dict(), str(path))
    again = sam.Sam.from_checkpoint(str(path), sam.VIT_TINY_TEST,
                                    device="cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(again.state_dict()[k], v), k
    other = sam.init_weights(sam.Sam(sam.VIT_TINY_TEST),
                             torch.Generator().manual_seed(3))
    assert torch.equal(other.image_encoder.pos_embed,
                       model.image_encoder.pos_embed)


def generator_image() -> np.ndarray:
    """tests/test_sam_jax.py's generator-contract image."""
    rng = np.random.default_rng(1)
    img = (rng.uniform(0, 60, (48, 64, 3))).astype(np.uint8)
    img[10:30, 20:50] = [200, 180, 40]     # a bright object
    return img


def test_generator_matches_jax(carried):
    params, model = carried
    img = generator_image()
    ref = sam_jax.JaxSamMaskGenerator(params, CFG, **GEN_SETTINGS)(img)
    gen = sam.TorchSamMaskGenerator(model, device="cpu", **GEN_SETTINGS)
    stats = {}
    got = gen.generate(img, stats)
    assert isinstance(got, tuple) and len(got) == 4
    assert stats["candidates"][1:] == [16, 16, 16]
    for lvl, (a, b) in enumerate(zip(got, ref)):
        assert len(a) == len(b) > 0, lvl
        for m, r in zip(a, b):
            assert set(m) == set(r) == {"segmentation", "bbox",
                                        "predicted_iou", "stability_score"}
            assert m["segmentation"].dtype == bool
            assert m["bbox"] == r["bbox"]
            np.testing.assert_array_equal(m["segmentation"],
                                          r["segmentation"])
            assert abs(m["predicted_iou"] - r["predicted_iou"]) <= 1e-5
            assert abs(m["stability_score"] - r["stability_score"]) <= \
                1e-4 * max(abs(r["stability_score"]), 1e-12)


def test_generator_thresholds_and_boxes(carried):
    """Default thresholds reject every random-weight mask (JAX's too);
    the batched boxes are `_box_from_mask`'s, empty masks included."""
    params, model = carried
    img = generator_image()
    kw = dict(points_per_side=4, points_per_batch=8)
    got = sam.TorchSamMaskGenerator(model, device="cpu", **kw)(img)
    ref = sam_jax.JaxSamMaskGenerator(params, CFG, **kw)(img)
    assert [len(x) for x in got] == [len(x) for x in ref]
    rng = np.random.default_rng(2)
    seg = rng.uniform(size=(6, 17, 23)) > 0.97
    seg[2] = False
    seg[3, 5, 7] = True
    boxes = sam.boxes_from_masks(torch.from_numpy(seg)).numpy()
    for s, b in zip(seg, boxes):
        assert b.tolist() == sam_jax._box_from_mask(s)


def test_box_nms_matches_jax():
    rng = np.random.default_rng(3)
    boxes = rng.integers(0, 40, (60, 4)).astype(np.float32)
    scores = np.round(rng.uniform(size=60), 1).astype(np.float32)  # ties
    for thr in (0.3, 0.7):
        assert sam._box_nms(boxes, scores, thr) == \
            sam_jax._box_nms(boxes, scores, thr)


def test_pipeline_files_byte_equal_with_tiny_sam(carried, tmp_path):
    params, model = carried
    img = generator_image()
    img2 = np.ascontiguousarray(img[::-1, ::-1])
    names = ["a.png", "b.png"]
    JaxPipeline(sam_jax.JaxSamMaskGenerator(params, CFG, **GEN_SETTINGS),
                "hash").run([img, img2], names, str(tmp_path / "jax"))
    PreprocessPipeline(
        sam.TorchSamMaskGenerator(model, device="cpu", **GEN_SETTINGS),
        "hash", device="cpu").run([img, img2], names, str(tmp_path / "port"))
    for n in ("a", "b"):
        for suffix in ("_s.npy", "_f.npy"):
            a = (tmp_path / "jax" / (n + suffix)).read_bytes()
            b = (tmp_path / "port" / (n + suffix)).read_bytes()
            assert a == b, n + suffix
