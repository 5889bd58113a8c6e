"""The port's spans and counters (langsplatv2_tpu_torch/tracing.py) on the
CPU: no span enters a profiler range outside a profiling session; inside
one, a serving frame opens "lsv2.render" over its layers and "lsv2.query"
twice, and a feature step (single or camera-batched) opens "lsv2.step"
over its phases, each in order and under its parent; the budget guard's
refusals count as "feature_step.redone"; the K1 counters count kernel
launches only."""
import os
import sys
import threading
import types

import numpy as np
import pytest
import torch

from langsplatv2_tpu_torch import tracing
from langsplatv2_tpu_torch.eval.openclip import OpenCLIPNetwork
from langsplatv2_tpu_torch.models.gaussians import from_numpy_params
from langsplatv2_tpu_torch.models.renderer import make_settings, render
from langsplatv2_tpu_torch.ops.rasterize import RasterizeSettings
from langsplatv2_tpu_torch.train import trainer

from torch_port_fixtures import (camera, model_fields,
                                 two_camera_feature_scene)

LAYERS = ["preprocess", "binning", "blend", "assemble"]
RENDER = [("render", None)] + [(n, "render") for n in LAYERS]
PHASES = [("accept", "step"), ("backward", "step"), ("optimizer", "step")]


def _frame():
    """A quick_relevancy frame: render the tile map, then the query."""
    model = from_numpy_params(model_fields(40), device="cpu")
    view, pm, tfx, tfy = camera(48, 64)
    s = RasterizeSettings(48, 64, tfx, tfy, 0, max_entries=2 ** 14,
                          assemble=False)
    out = render(s, model, view, pm, np.zeros(3, np.float32),
                 np.zeros(3, np.float32), quick_render=True, device="cpu")
    clip = OpenCLIPNetwork(backend="hash", device="cpu")
    clip.set_positives(["chair"])
    clip.relevancy_from_tiles(
        out.language_feature_weight_map,
        *clip.prompt_constants(model.codebooks), s.grid_x, s.grid_y, 48, 64)


def _feature_case():
    fields, cams = two_camera_feature_scene(k=16)
    model = from_numpy_params(fields, active_sh_degree=0, max_sh_degree=3,
                              device="cpu")
    opt = trainer.make_feature_optimizer(
        types.SimpleNamespace(language_feature_lr=0.01), model)
    settings = make_settings(cams[0], 0, max_entries=2 ** 14)
    views, gts = [], []
    for cam in cams:
        view, proj, campos, bg = trainer.camera_arrays(cam, (0, 0, 0))
        table, seg = cam.get_language_feature_compact(None, 1)
        table = np.pad(table, ((0, 512 - table.shape[0]), (0, 0)))
        views.append((view, proj, campos))
        gts.append(tuple(torch.from_numpy(a) for a in (table, seg)))
    return model, opt, settings, views, bg, gts


def _feature_step(accept=lambda m: True, group: bool = False):
    """One feature step, single or over both cameras as a group; returns
    whether it was applied."""
    model, opt, settings, views, bg, gts = _feature_case()
    if group:
        step = trainer.make_feature_group_step(settings, opt, topk=4)
        return step(model, views, bg, gts, accept=accept, device="cpu")[1]
    step = trainer.make_feature_train_step(settings, opt, topk=4)
    return step(model, *views[0], bg, *gts[0], accept=accept,
                device="cpu")[1]


def _forward_loss(with_topk: bool):
    """A camera's forward and loss in a feature step."""
    render_tree = RENDER[:1] + ([("topk_codes", "render")] if with_topk
                                else []) + RENDER[1:]
    return ([("forward", "step")]
            + [(n, p or "forward") for n, p in render_tree]
            + [("loss", "step")])


CASES = {
    "frame": (_frame, RENDER + [("query", None)] * 2),
    "feature_step": (_feature_step,
                     [("step", None)] + _forward_loss(True) + PHASES),
    "group_step": (lambda: _feature_step(group=True),
                   [("step", None), ("forward", "step"),
                    ("topk_codes", "forward")] + _forward_loss(False) * 2
                   + [("loss", "step")] + PHASES),
}


def _spans(prof) -> list:
    """(name, the nearest enclosing lsv2 span's name or None) of every
    lsv2 span, in the order they opened."""
    out = []
    for e in sorted(prof.events(), key=lambda e: e.time_range.start):
        if not e.name.startswith(tracing.PREFIX):
            continue
        p = e.cpu_parent
        while p is not None and not p.name.startswith(tracing.PREFIX):
            p = p.cpu_parent
        out.append((e.name[len(tracing.PREFIX):],
                    None if p is None else p.name[len(tracing.PREFIX):]))
    return out


@pytest.mark.parametrize("case", ["off"] + list(CASES))
def test_spans(case, monkeypatch):
    """Off: the spans are one shared no-op and no record_function is
    entered (a frame and a step run with it refusing); on: each case's
    spans in order, each under its parent."""
    if case == "off":
        def refuse(*a, **k):
            raise AssertionError("record_function entered without a "
                                 "profiling session")
        # The name tracing.span opens its ranges by (torch's optimizer
        # opens its own through torch.autograd.profiler, unpatched).
        monkeypatch.setattr(torch.profiler, "record_function", refuse)
        assert tracing.span("render") is tracing.span("step")
        _frame()
        assert _feature_step()
        return
    run, want = CASES[case]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        run()
    assert _spans(prof) == want


def _k1() -> dict:
    return {k: v for k, v in tracing.counters().items()
            if k.startswith("k1.")}


@pytest.mark.parametrize("case", ["redone", "redone_group", "k1_cpu",
                                  "registry", "threads"])
def test_counters(case):
    """feature_step.redone grows by one for each step the guard turns
    down, in both step makers, and not for an applied one; K1 on CPU
    tensors (its plain version) launches no kernel and counts nothing;
    counters() is a copy of the registry; counts from many threads at
    once are none of them lost."""
    if case.startswith("redone"):
        group = case == "redone_group"
        before = tracing.counters().get("feature_step.redone", 0)
        for _ in range(2):
            assert not _feature_step(lambda m: False, group)
        assert _feature_step(lambda m: True, group)
        assert tracing.counters()["feature_step.redone"] == before + 2
    elif case == "k1_cpu":
        before = _k1()
        _frame()
        _feature_step()
        assert _k1() == before
    elif case == "threads":
        before = tracing.counters().get("test.threads", 0)
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            workers = [threading.Thread(target=lambda: [
                tracing.count("test.threads") for _ in range(2000)])
                for _ in range(4 * (os.cpu_count() or 1))]
            for w in workers:
                w.start()
            for w in workers:
                w.join(timeout=60)
        finally:
            sys.setswitchinterval(interval)
        assert not any(w.is_alive() for w in workers)
        assert tracing.counters()["test.threads"] == before + 2000 * len(
            workers)
    else:
        before = tracing.counters().get("test.registry", 0)
        tracing.count("test.registry", 3)
        tracing.count("test.registry")
        got = tracing.counters()
        assert got["test.registry"] == before + 4
        got["test.registry"] = -1
        assert tracing.counters()["test.registry"] == before + 4


def _geometry_iteration(iteration: int):
    """One `rgb_iteration` on a small SH 0 model with 60 dead slots, its
    schedule set so that `iteration` ends with a densification round
    (every Gaussian hot) and no opacity reset. Returns (model before,
    model after)."""
    fields = {k: v for k, v in model_fields(40).items()
              if k in trainer.RGB_PARAM_NAMES + ("live",)}
    fields = {k: np.concatenate([v, np.zeros((60,) + v.shape[1:], v.dtype)])
              for k, v in fields.items()}
    fields["rotation"][40:, 0] = 1.0
    model = from_numpy_params(fields, device="cpu")
    opt = types.SimpleNamespace(
        position_lr_init=1.6e-4, position_lr_final=1.6e-6,
        position_lr_delay_mult=0.01, position_lr_max_steps=30_000,
        feature_lr=0.0025, opacity_lr=0.05, scaling_lr=0.005,
        rotation_lr=0.001, lambda_dssim=0.2, percent_dense=0.01,
        densify_grad_threshold=0.0, densification_interval=2,
        densify_from_iter=1, densify_until_iter=100,
        opacity_reset_interval=1000)
    optimizer = trainer.make_rgb_optimizer(opt, model)
    view, pm, tfx, tfy = camera(48, 64)
    cam = types.SimpleNamespace(
        image_height=48, image_width=64, tanfovx=tfx, tanfovy=tfy,
        world_view_transform=view, full_proj_transform=pm,
        camera_center=np.zeros(3, np.float32))
    image = torch.rand((3, 48, 64), generator=torch.Generator().manual_seed(0))
    new, _metrics = trainer.rgb_iteration(
        iteration, model, optimizer, cam, image, opt, 1.0,
        torch.Generator().manual_seed(1), trainer.TrainLogs(),
        iterations=100, max_entries=2 ** 14, device="cpu")
    return model, new


@pytest.mark.parametrize("iteration", [3, 4])
def test_geometry_spans(iteration):
    """rgb_iteration opens "step" over forward (the render's layers
    under it), loss, backward, optimizer and densify_stats; a scheduled
    iteration then opens "densify" beside "step", and no other does."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _geometry_iteration(iteration)
    want = ([("step", None), ("forward", "step"), ("render", "forward")]
            + [(n, "render") for n in LAYERS[:3]]
            + [(n, "step") for n in ("loss", "backward", "optimizer",
                                     "densify_stats")])
    if iteration % 2 == 0:
        want.append(("densify", None))
    assert _spans(prof) == want


def test_densify_counters_add_up():
    """A round counts once in densify.rounds, grows no capacity here, and
    its placed and pruned counts give the live count after it."""
    keys = ("densify.rounds", "densify.capacity_growths", "densify.placed",
            "densify.pruned")
    before = {k: tracing.counters().get(k, 0) for k in keys}
    model, new = _geometry_iteration(4)
    got = {k: tracing.counters().get(k, 0) - before[k] for k in keys}
    assert got["densify.rounds"] == 1 and got["densify.placed"] > 0
    assert got["densify.capacity_growths"] == 0
    assert int(new.num_live) == (int(model.num_live) + got["densify.placed"]
                                 - got["densify.pruned"])
