"""The reference render and its work counts on tiny scenes: the counts
equal a pixel-by-pixel loop, the blend equals the program's per-pixel
oracle, and the roofline's least times are positive."""
import numpy as np
import pytest
import torch

from portbench import common, roofline
from portbench.reference import render as ref

CFG = dict(n_gaussians=400, sh_degree=3, levels=3, codebook_size=8, topk=2,
           clip_dim=16, fovy_deg=60.0, znear=0.01, zfar=100.0,
           scene=dict(xy_range=[-1.5, 1.5], z_range=[2.0, 5.0],
                      scale_range=[0.02, 0.15], opacity_range=[0.2, 0.95],
                      sh_rest_scale=0.1))


def _setup(seed: int, w: int = 40, h: int = 24):
    scene = common.make_scene(CFG, seed, "cpu")
    cam = common.camera(7.0, [0.1, -0.2, 0.05], w, h, CFG)
    pr = ref.project(ref.activate(scene), cam, CFG["sh_degree"])
    return scene, cam, pr, ref.entries(pr)


def _brute_counts(pr, ent) -> dict:
    gx, _ = pr["grid"]
    xy, con, op = pr["xy"].numpy(), pr["conic"].numpy(), pr["op"].numpy()
    evaluated = included = needed = 0
    seen = set()
    for t in range(ent["count"].shape[0]):
        s, c = int(ent["start"][t]), int(ent["count"][t])
        ids = ent["g"][s:s + c].tolist()
        pix = [((t % gx) * 16 + p % 16, (t // gx) * 16 + p // 16)
               for p in range(256)]

        def alpha(g, px, py):
            dx, dy = np.float32(px) - xy[g, 0], np.float32(py) - xy[g, 1]
            power = (np.float32(-0.5) * (con[g, 0] * dx * dx
                                         + con[g, 2] * dy * dy)
                     - con[g, 1] * dx * dy)
            a = min(np.float32(0.99), op[g] * np.float32(np.exp(power)))
            return a if (power <= 0 and a >= 1.0 / 255.0) else None

        need = [any(alpha(g, *p) is not None for p in pix) for g in ids]
        needed += sum(need)
        seen |= {g for g, n in zip(ids, need) if n}
        for px, py in pix:
            T = 1.0
            for g, n in zip(ids, need):
                evaluated += n
                a = alpha(g, px, py)
                if a is None:
                    continue
                if T * (1 - a) < 1e-4:
                    break
                included += 1
                T *= 1 - a
    return dict(evaluated=evaluated, included=included, needed=needed,
                distinct=len(seen))


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 5])
def test_counts_equal_a_pixel_loop(seed):
    _scene, _cam, pr, ent = _setup(seed)
    assert ref.count_work(pr, ent) == _brute_counts(pr, ent)


@pytest.mark.parametrize("seed", [4, 2 ** 31 + 6])
def test_blend_equals_the_programs_oracle(seed):
    from langsplatv2_tpu_torch.ops.rasterize_reference import \
        rasterize_reference

    scene, cam, pr, ent = _setup(seed)
    codes = common.quick_codes(CFG, seed, "cpu")
    C = CFG["levels"] * CFG["codebook_size"]
    out = ref.blend(pr, ent, codes["quick_weights"], codes["quick_indices"],
                    C)
    dense = torch.zeros(CFG["n_gaussians"], C).scatter_add_(
        1, codes["quick_indices"].long(), codes["quick_weights"])
    shs = torch.cat([scene["features_dc"], scene["features_rest"]], 1)
    rgb, feat, _r, final_t = rasterize_reference(
        scene["xyz"], torch.sigmoid(scene["opacity"]),
        torch.exp(scene["scaling"]), scene["rotation"], None, shs, None,
        dense, cam["view"], cam["proj"], cam["campos"], cam["tanfovx"],
        cam["tanfovy"], cam["width"], cam["height"], CFG["sh_degree"],
        torch.zeros(3), device="cpu")
    gx, gy = pr["grid"]
    H, W = cam["height"], cam["width"]
    got = ref.tiles_to_image(out["feat"], gx, gy, H, W)
    torch.testing.assert_close(got, feat, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(ref.tiles_to_image(out["rgb"], gx, gy, H, W),
                               rgb, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(ref.tiles_to_image(
        out["final_t"][..., None], gx, gy, H, W)[0], final_t, rtol=1e-4,
        atol=1e-5)


def test_least_times_are_positive_and_bounded_by_a_rate():
    _scene, _cam, pr, ent = _setup(9)
    work = ref.count_work(pr, ent)
    tiles = pr["grid"][0] * pr["grid"][1]
    for t in (roofline.preprocess(1000, 3), roofline.binning(1000, 50, 6),
              roofline.blend(work, tiles, 24, 6),
              roofline.query(tiles, 3, 8, 2, 4, 24, 40, 16),
              roofline.gram_fwd(1536, 64, 512, 512),
              roofline.gram_bwd(1536, 64, 64, 512),
              roofline.feature_bwd(work, tiles, 64), roofline.adam(10)):
        assert t > 0
    nbytes = 1e9
    assert roofline.least_s(nbytes) == pytest.approx(
        nbytes / roofline.HBM_BYTES_PER_S)


def test_image_tiles_round_trip():
    img = torch.arange(24 * 40, dtype=torch.float32).reshape(24, 40)
    t = ref.image_to_tiles(img, 3, 2, fill=-1.0)
    assert t.shape == (6, 256) and float(t.min()) == -1.0
    back = ref.tiles_to_image(t[..., None], 3, 2, 24, 40)[0]
    torch.testing.assert_close(back, img)

