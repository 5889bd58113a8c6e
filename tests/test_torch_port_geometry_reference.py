"""The port's geometry step and densification round against the
benchmark's plain reference (portbench/reference/geometry.py, 3DGS's
Stage B written from the published method) on the CPU, at 2,000 seeded
Gaussians, SH degree 3, 64x96, with dead slots beside the live ones:
`rgb_step`'s loss, the six leaves' gradients and the means2D statistic;
the parameters after 3 steps of Adam; one `run_densify` round given the
same statistics and split noise (the live count and the rows, whatever
their slots). A program that leaves SSIM out of its loss (L1 only) fails
the step's tolerances, and a round given other noise the round's.

Tolerances, each over the larger of the leaf's reference norm and the
median leaf's (a leaf with a tiny gradient, such as the higher SH terms,
is held to the others' scale):
- LOSS 1e-6 relative: both sum the same 18,432 f32 values in another
  order (about 1e-7; 0 was read); the reference with TF32 operands reads
  1.2e-4, and SSIM's share of the loss is about 0.2 of it;
- GRAD 1e-4: the blend's gradient summed per pixel in another order
  (the reference's cumulative products against K7's plain replay), the
  SSIM adjoint through another convolution; at most 8e-7 was read, and
  the reference with TF32 operands reads 6e-4 to 7e-3;
- CHANGE 1e-4 on each leaf's norm of change after 3 steps: Adam
  normalizes each element's gradient, so an element whose gradient is
  rounding noise may step either way, which moves the norm little;
- ROUND 1e-6: the round's arithmetic is elementwise (exp, a rotation of
  the noise), the same in both.
"""
import json
import statistics
import types

import pytest
import torch

from langsplatv2_tpu_torch.models.gaussians import GaussianModel
from langsplatv2_tpu_torch.models.renderer import make_settings
from langsplatv2_tpu_torch.train import trainer
from langsplatv2_tpu_torch.utils import losses
from portbench import common
from portbench.entries.geometry_step import padded, set_gap
from portbench.reference import geometry as ref

LOSS, GRAD, CHANGE, ROUND = 1e-6, 1e-4, 1e-4, 1e-6
N, CAP, H, W = 2000, 2560, 64, 96
CFG = {**common.load_json(common.HERE / "configs" / "lerf_rgb_1m.json"),
       "n_gaussians": N,
       "scene": dict(xy_range=[-1.5, 1.5], z_range=[2.0, 5.0],
                     scale_range=[0.01, 0.08], opacity_range=[0.2, 0.95],
                     sh_rest_scale=0.1)}
SEED = 2 ** 31 + 11


def _opt():
    lr = CFG["lr"]
    return types.SimpleNamespace(
        position_lr_init=lr["position_init"],
        position_lr_final=lr["position_final"],
        position_lr_delay_mult=lr["position_delay_mult"],
        position_lr_max_steps=lr["position_max_steps"],
        feature_lr=lr["feature"], opacity_lr=lr["opacity"],
        scaling_lr=lr["scaling"], rotation_lr=lr["rotation"],
        **{k: CFG[k] for k in ("lambda_dssim", "percent_dense",
                               "densify_grad_threshold")})


def _case(seed: int = SEED):
    """The scene in CAP slots (the model and the raw live rows), two
    cameras and their targets (uniform images)."""
    scene = common.make_scene(CFG, seed, "cpu")
    model = GaussianModel(**padded(scene, CAP), active_sh_degree=3,
                          max_sh_degree=3, spatial_lr_scale=1.5)
    g = torch.Generator().manual_seed(seed % 2 ** 32)
    cams = [common.camera(yaw, [0.1 * yaw, -0.05, 0.02], W, H, CFG)
            for yaw in (-5.0, 4.0)]
    gts = [torch.rand((3, H, W), generator=g) for _ in cams]
    return model, scene, cams, gts


def _program_steps(model, cams, gts, n_steps: int):
    """n_steps of rgb_step on the cameras in turn; returns the losses,
    the first step's gradients on the live rows (the six leaves and the
    means2D carrier's) and the model."""
    optimizer = trainer.make_rgb_optimizer(_opt(), model)
    live = model.live.clone()
    out, first = [], None
    for i in range(n_steps):
        cam, gt = cams[i % len(cams)], gts[i % len(gts)]
        c = common.Camera(cam)
        view, proj, campos, bg = trainer.camera_arrays(c, (0, 0, 0))
        m = trainer.rgb_step(make_settings(c, 3, max_entries=2 ** 16),
                             optimizer, CFG["lambda_dssim"], model, view,
                             proj, campos, bg, gt, device="cpu")
        out.append(float(m["loss"]))
        if first is None:
            first = {k: getattr(model, k).grad[live].clone()
                     for k in ref.LEAVES}
            first["means2d"] = m["means2d_grad"][live].clone()
    return out, first, model


def _gaps(got: dict, want: dict) -> dict:
    """Each entry's |got - want| over the larger of |want| and the median
    entry's."""
    norms = {k: float(torch.linalg.norm(v)) for k, v in want.items()}
    med = statistics.median(norms.values())
    return {k: float(torch.linalg.norm(got[k] - want[k]))
            / max(norms[k], med) for k in want}


@pytest.fixture(scope="module")
def step_case():
    model, scene, cams, gts = _case()
    losses_, first, _ = _program_steps(model, cams, gts, 1)
    want = ref.step_grads(scene, cams[0], gts[0], CFG)
    return losses_[0], first, want


def test_step_loss(step_case):
    got, _first, want = step_case
    assert abs(got - want["loss"]) / want["loss"] <= LOSS


def test_step_gradients(step_case):
    _loss, first, want = step_case
    gaps = _gaps(first, dict(want["grads"], means2d=want["means2d"]))
    assert max(gaps.values()) <= GRAD, gaps
    assert all(float(torch.linalg.norm(first[k])) > 0 for k in first)


def test_means2d_statistic(step_case):
    """The statistic the round reads: the norm of the carrier's gradient
    on the visible Gaussians (the reference's dL/dxy times W/2, H/2)."""
    _loss, first, want = step_case
    got = torch.linalg.norm(first["means2d"], dim=-1)
    ref_stat = torch.where(want["visible"],
                           torch.linalg.norm(want["means2d"], dim=-1), 0.0)
    assert float(torch.linalg.norm(got - ref_stat)) <= GRAD * float(
        torch.linalg.norm(ref_stat))
    assert bool((got[~want["visible"]] == 0).all())


def test_parameters_after_three_steps():
    model, scene, cams, gts = _case(SEED + 1)
    live = model.live.clone()
    got_losses, _first, model = _program_steps(model, cams, gts, 3)
    moments0 = {k: (torch.zeros_like(v), torch.zeros_like(v))
                for k, v in scene.items()}
    want = ref.geometry_steps(scene, moments0, 0, [
        dict(cam=cams[i % 2], gt=gts[i % 2]) for i in range(3)], CFG, 1.5)
    for a, b in zip(got_losses, want["losses"]):
        assert abs(a - b) / b <= LOSS
    for k in ref.LEAVES:
        d = getattr(model, k).detach()[live] - scene[k]
        w = want["change"][k]
        assert abs(float(torch.linalg.norm(d)) - float(torch.linalg.norm(w))) \
            <= CHANGE * float(torch.linalg.norm(w)), k
        assert float(torch.linalg.norm(d - w)) <= 1e-2 * float(
            torch.linalg.norm(w)), k


def test_l1_only_fails(monkeypatch):
    """A program whose loss leaves SSIM out fails the step's tolerances."""
    model, scene, cams, gts = _case()
    monkeypatch.setattr(losses, "ssim", lambda a, b: torch.ones((), ))
    (got,), first, _ = _program_steps(model, cams, gts, 1)
    want = ref.step_grads(scene, cams[0], gts[0], CFG)
    gaps = _gaps(first, dict(want["grads"], means2d=want["means2d"]))
    assert abs(got - want["loss"]) / want["loss"] > LOSS
    assert max(gaps.values()) > GRAD


def _round_case(size_threshold: bool):
    """A model whose statistics make some Gaussians hot (half of them
    small enough to clone), a few with zero counts, a few transparent
    and (for the size threshold) a few too large; the optimizer after a
    step, so that the moments exist."""
    model, scene, cams, gts = _case(SEED + 2)
    _program_steps(model, cams, gts, 1)
    g = torch.Generator().manual_seed(3)
    live = model.live
    with torch.no_grad():
        denom = torch.randint(0, 4, (CAP, 1), generator=g).float()
        model.denom.copy_(torch.where(live[:, None], denom, 0.0))
        model.xyz_gradient_accum.copy_(
            4e-4 * torch.rand((CAP, 1), generator=g) * model.denom)
        pick = torch.rand(CAP, generator=g)
        model.opacity[pick < 0.05] = -6.0           # opacity < 0.005
        model.scaling[pick > 0.97, 0] = 0.0          # scale 1 > 0.1 extent
        model.scaling[(pick > 0.5) & (pick < 0.75)] = -5.0   # cloned
    return model


@pytest.mark.parametrize("case", ["threshold_on", "threshold_off",
                                  "other_noise"])
def test_densify_round(case):
    """run_densify against the reference's round on the same state,
    statistics and noise: the same live count and the same rows,
    compared regardless of slot order; the reference given other noise
    differs by far more than ROUND."""
    model = _round_case(case != "threshold_off")
    extent = 1.5
    optimizer = trainer.make_rgb_optimizer(_opt(), model)
    live = model.live.clone()
    fields = {k: getattr(model, k).detach()[live].clone() for k in ref.LEAVES}
    accum = model.xyz_gradient_accum[live, 0].clone()
    denom = model.denom[live, 0].clone()
    eps = torch.randn((2, CAP, 3), generator=torch.Generator().manual_seed(9))
    if case == "other_noise":
        eps = torch.randn((2, CAP, 3),
                          generator=torch.Generator().manual_seed(10))
    threshold = 0.0 if case == "threshold_off" else 20.0
    new = trainer.run_densify(model, optimizer,
                              torch.Generator().manual_seed(9), _opt(),
                              extent, threshold)
    assert new.capacity == CAP
    want = ref.densify_round(fields, accum, denom, eps[:, live], extent, CFG,
                             threshold > 0)
    got = {k: getattr(new, k).detach()[new.live] for k in ref.LEAVES}
    gap = set_gap(got, want)
    n_hot = int(((accum / denom) >= CFG["densify_grad_threshold"]).sum())
    assert n_hot > 100
    if case == "other_noise":
        assert gap > 1e3 * ROUND, gap
    else:
        assert int(new.num_live) == want["xyz"].shape[0]
        assert gap <= ROUND, gap


def test_config_file_is_the_papers():
    """The configuration's settings are 3DGS's OptimizationParams."""
    cfg = json.loads((common.HERE / "configs" / "lerf_rgb_1m.json")
                     .read_text())
    assert (cfg["lambda_dssim"], cfg["percent_dense"],
            cfg["densify_grad_threshold"], cfg["densification_interval"],
            cfg["opacity_reset_interval"], cfg["densify_from_iter"],
            cfg["densify_until_iter"]) == (0.2, 0.01, 0.0002, 100, 3000,
                                           500, 15000)
    assert cfg["lr"]["position_init"] == 0.00016 and cfg["sh_degree"] == 3
