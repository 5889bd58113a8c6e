"""The eval slice, port against JAX: the CLIP network's relevancy, the
post-processing and metrics, and the LERF drivers
(langsplatv2_tpu_torch/eval/{openclip,processing,lerf}.py against
langsplatv2_tpu/eval/...), mirroring tests/test_eval.py, plus the golden
fixture through the port alone. Inputs are numpy arrays from a seed handed
to both packages; models are the JAX models' fields. Tolerances: relevancy
1e-5, IoU 1e-6, chosen levels and localization hits equal.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from langsplatv2_tpu.eval import lerf as jlerf
from langsplatv2_tpu.eval import processing as jproc
from langsplatv2_tpu.eval.openclip import OpenCLIPNetwork as JaxNetwork
from langsplatv2_tpu.models import gaussians as jgm
from langsplatv2_tpu.models import io as jax_io
from langsplatv2_tpu.models.renderer import make_settings as jax_settings
from langsplatv2_tpu_torch.eval import lerf, processing
from langsplatv2_tpu_torch.eval.openclip import OpenCLIPNetwork
from langsplatv2_tpu_torch.models import gaussians as gm
from langsplatv2_tpu_torch.models.renderer import make_settings

from scene_fixtures import make_camera, random_gaussians
from torch_port_fixtures import check_golden_eval, golden_eval

H, W = 48, 64


def _t(a):
    return torch.from_numpy(np.array(a))


def _nets(prompts=None):
    net, jnet = OpenCLIPNetwork(device="cpu"), JaxNetwork(backend="hash")
    if prompts:
        net.set_positives(prompts)
        jnet.set_positives(prompts)
    return net, jnet


# ---------------------------------------------------------------- relevancy

class TestRelevancy:
    def test_relevancy_matches_jax(self):
        net, jnet = _nets(["cat", "dog"])
        pos = np.asarray(jnet.pos_embeds[0])
        neg = np.asarray(jnet.neg_embeds[0])
        rng = np.random.default_rng(0)
        embed = np.stack([pos, neg, -pos, *rng.normal(size=(5, 512))]
                         ).astype(np.float32)
        for pid in (0, 1):
            rel = net.get_relevancy(_t(embed), pid).numpy()
            ref = np.asarray(jnet.get_relevancy(jnp.asarray(embed), pid))
            np.testing.assert_allclose(rel, ref, atol=1e-5, rtol=0)
        rel = net.get_relevancy(_t(embed), 0).numpy()
        assert rel[0, 0] > 0.9 and rel[1, 0] < 0.5 and rel[2, 0] < 0.2
        np.testing.assert_allclose(rel.sum(axis=1), 1.0, atol=1e-5)

    def test_quick_matches_loop_and_jax(self):
        net, jnet = _nets(["cat", "dog"])
        sem = np.random.default_rng(0).normal(size=(3, 6, 8, 512))
        sem = (sem / np.linalg.norm(sem, axis=-1, keepdims=True)
               ).astype(np.float32)
        slow = net.get_max_across(_t(sem)).numpy()
        quick = net.get_max_across_quick(_t(sem)).numpy()
        ref = np.asarray(jnet.get_max_across_quick(jnp.asarray(sem)))
        np.testing.assert_allclose(quick, slow, atol=1e-5, rtol=0)
        np.testing.assert_allclose(quick, ref, atol=1e-5, rtol=0)
        np.testing.assert_allclose(
            slow, np.asarray(jnet.get_max_across(jnp.asarray(sem))),
            atol=1e-5, rtol=0)

    def test_semantic_map_and_image_encoding(self):
        net, jnet = _nets()
        net.set_semantics(["apple", "banana"])
        jnet.set_semantics(["apple", "banana"])
        a, b = (np.asarray(jnet.semantic_embeds[i]) for i in (0, 1))
        neg = np.asarray(jnet.neg_embeds[0])
        sem = np.stack([a, b, neg]).reshape(1, 1, 3, 512)
        pred = net.get_semantic_map(_t(sem)).numpy()
        assert pred.tolist() == [[[0, 1, -1]]]
        assert pred.tolist() == np.asarray(
            jnet.get_semantic_map(jnp.asarray(sem))).tolist()
        imgs = np.random.default_rng(2).uniform(size=(2, 3, 8, 8)).astype(
            np.float32)
        np.testing.assert_array_equal(net.encode_image(imgs).numpy(),
                                      np.asarray(jnet.encode_image(imgs)))


class TestGramRelevancy:
    def test_matches_decoded_relevancy_and_jax(self):
        prompts = ["red apple", "blue chair", "grass"]
        net, jnet = _nets(prompts)
        rng = np.random.default_rng(0)
        L, K, h, w = 3, 64, 24, 32
        cb = rng.normal(size=(L, K, 512)).astype(np.float32)
        wm = np.abs(rng.normal(size=(L * K, h, w))).astype(np.float32)
        feats = np.einsum("lkd,lkp->ldp", cb, wm.reshape(L, K, h * w))
        feats /= np.linalg.norm(feats, axis=1, keepdims=True) + 1e-10
        sem = feats.reshape(L, 512, h, w).transpose(0, 2, 3, 1)
        fast = net.get_max_across_from_weights(_t(wm), _t(cb)).numpy()
        ref = net.get_max_across_quick(_t(sem)).numpy()
        np.testing.assert_allclose(fast, ref, atol=2e-5, rtol=0)
        np.testing.assert_allclose(
            fast, np.asarray(jnet.get_max_across_from_weights(
                jnp.asarray(wm), jnp.asarray(cb))), atol=1e-5, rtol=0)


# --------------------------------------------------------------- processing

def _heat(seed, shape=(64, 64)):
    """Smooth random heatmaps with a few hot blobs (no exact ties)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:shape[0], :shape[1]]
    h = rng.uniform(0, 0.05, shape)
    for _ in range(3):
        cy, cx = rng.uniform(8, shape[0] - 8), rng.uniform(8, shape[1] - 8)
        h += rng.uniform(0.3, 1) * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2)
                                          / rng.uniform(20, 120))
    return h.astype(np.float32)


class TestProcessing:
    def test_avg_pool_count_include_pad_false(self):
        x = np.arange(9, dtype=np.float32).reshape(3, 3)
        out = processing.avg_pool_same(_t(x), 3, 1).numpy()
        assert out[0, 0] == pytest.approx(2.0)
        assert out[1, 1] == pytest.approx(4.0)

    @pytest.mark.parametrize("kernel,pad", [(3, 1), (7, 3), (29, 14)])
    def test_avg_pool_matches_jax(self, kernel, pad):
        x = _heat(kernel)
        np.testing.assert_allclose(
            processing.avg_pool_same(_t(x), kernel, pad).numpy(),
            np.asarray(jproc.avg_pool_same(jnp.asarray(x), kernel, pad)),
            rtol=1e-6, atol=1e-7)

    def test_heatmap_to_mask_matches_jax(self):
        h = np.zeros((64, 64), np.float32)
        h[20:40, 20:40] = 1.0
        for x in (h, _heat(5)):
            blended, mask = processing.heatmap_to_mask(_t(x), 0.4)
            jb, jm = jproc.heatmap_to_mask(jnp.asarray(x), 0.4)
            np.testing.assert_allclose(blended.numpy(), np.asarray(jb),
                                       rtol=1e-6, atol=1e-7)
            np.testing.assert_array_equal(mask.numpy(), np.asarray(jm))
        assert mask.dtype == torch.uint8

    def test_segmentation_matches_jax(self):
        h = np.zeros((2, 1, 64, 64), np.float32)
        h[0, 0, 16:32, 16:32] = 1.0
        h[1, 0, 40:48, 40:48] = 0.6
        gt = np.zeros((64, 64), bool)
        gt[16:32, 16:32] = True
        ious, lvls, _ = processing.segmentation_process(_t(h), 0.4,
                                                        {"obj": gt}, ["obj"])
        assert lvls == [0] and ious[0] > 0.8
        vm = np.stack([np.stack([_heat(10 * lvl + k) for k in range(3)])
                       for lvl in range(3)])
        prompts = ["a", "b", "c"]
        rng = np.random.default_rng(9)
        masks = {p: rng.uniform(size=(64, 64)) > 0.7 for p in prompts}
        out = processing.segmentation_process(_t(vm), 0.4, masks, prompts)
        ref = jproc.segmentation_process(jnp.asarray(vm), 0.4, masks,
                                         prompts)
        np.testing.assert_allclose(out[0], ref[0], atol=1e-6, rtol=0)
        assert out[1] == ref[1]
        for p in prompts:
            np.testing.assert_allclose(out[2][p], ref[2][p], atol=1e-6)

    def test_localization_matches_jax(self):
        h = np.zeros((1, 1, 64, 64), np.float32)
        h[0, 0, 28:36, 28:36] = 1.0
        hit = {"obj": np.array([24, 24, 40, 40])}
        miss = {"obj": np.array([50, 2, 62, 12])}
        assert processing.localization_process(_t(h), hit, ["obj"]) == 1
        assert processing.localization_process(_t(h), miss, ["obj"]) == 0
        vm = np.stack([np.stack([_heat(7 * lvl + k + 1) for k in range(4)])
                       for lvl in range(3)])
        prompts = ["a", "b", "c", "d"]
        rng = np.random.default_rng(4)
        boxes = {p: np.concatenate([rng.integers(0, 32, (2, 2)),
                                    rng.integers(32, 64, (2, 2))], axis=1)
                 for p in prompts}
        boxes["a"] = np.array([0, 0, 63, 63])
        boxes["b"] = np.array([0, 0, 2, 2])
        got = processing.localization_process(_t(vm), boxes, prompts)
        assert got == jproc.localization_process(vm, boxes, prompts)
        assert 0 < got < 4

    def test_masks_and_mode_filter_match_jax(self):
        pts = [[1, 1], [8, 1], [8, 8], [1, 8]]
        mask = processing.polygon_to_mask((10, 10), pts)
        np.testing.assert_array_equal(mask,
                                      jproc.polygon_to_mask((10, 10), pts))
        assert mask[5, 5] and not mask[0, 0]
        lab = np.random.default_rng(3).integers(0, 3, (12, 12))
        np.testing.assert_array_equal(processing.mode_smooth(lab),
                                      jproc.mode_smooth(lab))


# ------------------------------------------------------------ LERF drivers

class FakeCam:
    def __init__(self, cam, h=H, w=W):
        self.world_view_transform = np.asarray(cam["viewmatrix"])
        self.full_proj_transform = np.asarray(cam["projmatrix"])
        self.camera_center = np.asarray(cam["campos"])
        self.tanfovx, self.tanfovy = cam["tanfovx"], cam["tanfovy"]
        self.image_height, self.image_width = h, w


def _port_model(jm):
    fields = {k: np.asarray(getattr(jm, k)) for k in jax_io.MODEL_FIELDS
              if getattr(jm, k) is not None}
    return gm.from_numpy_params(fields, active_sh_degree=jm.active_sh_degree,
                                max_sh_degree=jm.max_sh_degree,
                                device="cpu")


@pytest.fixture(scope="module")
def level_models():
    """test_eval.py's scene: 3 per-level models of 40 splats (1 layer, 64
    codes each), their merge, and the camera, in both packages."""
    rng = np.random.default_rng(0)
    n = 40
    g = random_gaussians(rng, n)
    jmodels = []
    for lvl in range(3):
        m = jgm.create_from_pcd(np.asarray(g["means3d"]),
                                np.full((n, 3), 0.5, np.float32), 1.0)
        m = m.replace(opacity=jnp.full((n, 1), 1.5))
        jmodels.append(jgm.init_language_features(
            m, jax.random.PRNGKey(lvl), 1, 64))
    models = [_port_model(m) for m in jmodels]
    return dict(models=models, jmodels=jmodels,
                merged=lerf.merge_level_models(models),
                jmerged=jlerf.merge_level_models(jmodels),
                cam=FakeCam(make_camera(H, W)))


def _gt_ann():
    mask = np.zeros((H, W), bool)
    mask[10:30, 20:44] = True
    mask2 = np.zeros((H, W), bool)
    mask2[5:20, 5:25] = True
    return {"0": {"cup": {"mask": mask, "bboxes": np.array([20, 10, 44, 30])},
                  "plate": {"mask": mask2,
                            "bboxes": np.array([[5, 5, 25, 20],
                                                [40, 30, 60, 45]])}}}


class TestLerfQuickPath:
    def test_quick_feature_map_matches_jax(self, level_models):
        c = level_models
        cam = c["cam"]
        view, proj, campos = (cam.world_view_transform,
                              cam.full_proj_transform, cam.camera_center)
        feats = lerf.render_language_feature_map_quick(
            c["merged"], make_settings(cam, 0, 1.0, 2 ** 14), view, proj,
            campos, np.zeros(3, np.float32), device="cpu")
        ref = jlerf.render_language_feature_map_quick(
            c["jmerged"], jax_settings(cam, 0, 1.0, 2 ** 14, 256, 8),
            jnp.asarray(view), jnp.asarray(proj), jnp.asarray(campos),
            jnp.zeros(3))
        assert feats.shape == (3, 512, H, W)
        np.testing.assert_allclose(feats.numpy(), np.asarray(ref), atol=1e-5,
                                   rtol=0)
        norms = np.linalg.norm(feats.numpy(), axis=1)
        assert norms.max() == pytest.approx(1.0, abs=1e-4)

    @pytest.mark.parametrize("gram", [True, False], ids=["gram", "decode"])
    def test_evaluate_quick_matches_jax(self, level_models, gram):
        c = level_models
        net, jnet = _nets()
        out = lerf.evaluate_quick(c["merged"], [c["cam"]], _gt_ann(), (H, W),
                                  net, gram_relevancy=gram, device="cpu")
        ref = jlerf.evaluate_quick(c["jmerged"], [c["cam"]], _gt_ann(),
                                   (H, W), jnet, gram_relevancy=gram)
        assert out["num_prompts"] == ref["num_prompts"] == 2
        np.testing.assert_allclose(out["mean_iou"], ref["mean_iou"],
                                   atol=1e-6)
        assert out["chosen_levels"] == ref["chosen_levels"]
        assert out["localization_accuracy"] == ref["localization_accuracy"]

    def test_nonquick_evaluate_agrees_with_quick_and_jax(self, level_models):
        c = level_models
        net, jnet = _nets()
        quick = lerf.evaluate_quick(c["merged"], [c["cam"]], _gt_ann(),
                                    (H, W), net, gram_relevancy=False,
                                    device="cpu")
        full = lerf.evaluate(c["models"], [c["cam"]], _gt_ann(), (H, W), net,
                             device="cpu")
        ref = jlerf.evaluate(c["jmodels"], [c["cam"]], _gt_ann(), (H, W),
                             jnet)
        for other in (quick, ref):
            np.testing.assert_allclose(full["mean_iou"], other["mean_iou"],
                                       atol=1e-6)
            assert full["chosen_levels"] == other["chosen_levels"]
            assert (full["localization_accuracy"]
                    == other["localization_accuracy"])

    def test_gt_parsing_matches_jax(self, tmp_path):
        ann = {
            "info": {"name": "frame_00001.jpg", "height": 32, "width": 40},
            "objects": [
                {"category": "cup", "bbox": [2, 3, 10, 12],
                 "segmentation": [[2, 3], [10, 3], [10, 12], [2, 12]]},
                {"category": "cup", "bbox": [20, 20, 30, 28],
                 "segmentation": [[20, 20], [30, 20], [30, 28], [20, 28]]},
            ],
        }
        with open(tmp_path / "frame_00001.json", "w") as f:
            json.dump(ann, f)
        gt_ann, hw, _ = lerf.eval_gt_lerfdata(str(tmp_path),
                                              str(tmp_path / "out"))
        ref, hw_ref, _ = jlerf.eval_gt_lerfdata(str(tmp_path))
        assert hw == hw_ref == (32, 40)
        cup = gt_ann["0"]["cup"]
        assert cup["bboxes"].reshape(-1, 4).shape[0] == 2
        assert cup["mask"][5, 5] and cup["mask"][24, 24]
        np.testing.assert_array_equal(cup["mask"], ref["0"]["cup"]["mask"])
        np.testing.assert_array_equal(cup["bboxes"], ref["0"]["cup"]["bboxes"])
        assert (tmp_path / "out" / "gt" / "frame_00001" / "cup.jpg").exists()


def test_golden_fixture_through_the_port():
    """tests/golden/eval_golden.npz reproduced by the port alone (no JAX
    call) at the fixture test's atol 1e-5; the same check runs on the card
    in tests/test_torch_port_gpu.py and chip_smoke.py phase 19."""
    errs = check_golden_eval(golden_eval("cpu"))
    assert errs["rel_gram"] <= 1e-5


def test_evaluate_quick_scores_an_overflowing_frame_truncated(
        level_models, monkeypatch):
    """A fault of the reference, mirrored: evaluate_quick renders with
    make_settings' entry budget and never reads total_entries, so a frame
    whose expansion overflows is scored on a truncated frame without a
    word. With the budget cut to 256 entries (2**21 in both packages'
    defaults; the 1M bench scene overflows it at 986x728), both packages
    score the same truncated frame; the port's quick_relevancy returns the
    RenderOutput, whose total_entries == max_entries shows the overflow."""
    c = level_models

    def small(cam, sh, *a, **k):
        return make_settings(cam, sh, 1.0, 256)

    def jsmall(cam, sh, *a, **k):
        return jax_settings(cam, sh, 1.0, 256)

    full, _ = _nets()
    ref_full = lerf.evaluate_quick(c["merged"], [c["cam"]], _gt_ann(),
                                   (H, W), full, device="cpu")
    monkeypatch.setattr(lerf, "make_settings", small)
    monkeypatch.setattr(jlerf, "make_settings", jsmall)
    net, jnet = _nets()
    out = lerf.evaluate_quick(c["merged"], [c["cam"]], _gt_ann(), (H, W),
                              net, device="cpu")
    ref = jlerf.evaluate_quick(c["jmerged"], [c["cam"]], _gt_ann(), (H, W),
                               jnet)
    np.testing.assert_allclose(out["mean_iou"], ref["mean_iou"], atol=1e-6)
    assert out["chosen_levels"] == ref["chosen_levels"]
    net.set_positives(["cup"])
    _, rendered = lerf.quick_relevancy(c["merged"], c["cam"], net,
                                       device="cpu")
    assert int(rendered.total_entries) == 256
    assert (out["mean_iou"], out["chosen_levels"]) != (
        ref_full["mean_iou"], ref_full["chosen_levels"])
