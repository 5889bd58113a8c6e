"""Training: the feature phase's exact step
(train/trainer.py::make_feature_train_step, cosine loss only, so the Gram
loss on tile maps: the top-k codes, K1 -> sort -> K2, K6a, then K6b, K4
and Adam), driven as train_features drives it: the trainer's camera
order, settings from make_settings each step with the live budget, and
its guard (budget_check, trainer.py:716-740): the first step of a camera
signature runs at the full budget and sets the live budget; a step whose
live total passes it grows the budget and is redone; the loss is read
each step (the trainer's running loss).

The entry budget is probed over the cell's views (1.07 times the largest
total, rounded up to 4,096) where train_features takes 2**21 by default.
"""
from __future__ import annotations

import contextlib
import statistics
import time
from types import SimpleNamespace

import numpy as np
import torch

from .. import common, roofline, trace, traffic
from ..reference import render as ref_render
from ..reference.train import LEAVES, feature_steps

CHECKED_STEPS = 3


def setup(ctx) -> SimpleNamespace:
    from langsplatv2_tpu_torch.models.gaussians import GaussianModel
    from langsplatv2_tpu_torch.models.renderer import make_settings, render
    from langsplatv2_tpu_torch.train import trainer

    cfg, dev = ctx.cfg, ctx.device
    st = SimpleNamespace()
    st.cfg, st.spec, st.dev, st.seed = cfg, ctx.spec, dev, ctx.seed
    st.scene = common.make_scene(cfg, ctx.seed, dev)
    st.codes = common.feature_codes(cfg, ctx.seed, dev)
    st.traffic = traffic.generate(ctx.mix, cfg, ctx.seed, dev)
    st.cams = [common.Camera(c) for c in st.traffic["cameras"]]
    # The trainer's compact GT: the table padded to a multiple of 512 rows
    # (trainer.py get_gt), the segment map as it is.
    st.gt = []
    for table, seg in zip(st.traffic["tables"], st.traffic["segments"]):
        pad = -(-table.shape[0] // 512) * 512
        st.gt.append((torch.nn.functional.pad(
            table, (0, 0, 0, pad - table.shape[0])), seg))
    st.model = GaussianModel(
        **st.scene, language_logits=st.codes["language_logits"].clone(),
        codebooks=st.codes["codebooks"].clone(),
        active_sh_degree=cfg["sh_degree"], max_sh_degree=cfg["sh_degree"])
    st.opt = trainer.make_feature_optimizer(
        SimpleNamespace(language_feature_lr=cfg["language_feature_lr"]),
        st.model)
    st.opt.zero_grad(set_to_none=True)
    st.trainer, st.make_settings = trainer, make_settings
    probe = ctx.spec["probe_entries"]
    totals = []
    with torch.no_grad():
        for cam in st.cams:
            s = make_settings(cam, cfg["sh_degree"], max_entries=probe)
            out = render(s._replace(assemble=False), st.model,
                         cam.world_view_transform, cam.full_proj_transform,
                         cam.camera_center, torch.zeros(3, device=dev),
                         include_feature=True, topk=cfg["topk"], device=dev)
            totals.append(int(out.total_entries))
            del out
    if max(totals) >= probe:
        raise RuntimeError(f"the probe budget {probe} is full "
                           f"({max(totals)} entries)")
    st.max_entries = -(-int(max(totals) * 1.07) // 4096) * 4096
    st.live_budget, st.k, st.losses = {}, 0, []
    # The check's steps go through the window's own call: the first
    # gradient as Adam holds it after step 1, the change after step 3.
    b1 = cfg["adam_betas"][0]
    run(st, steps=1)
    st.prog_first_grad = {}
    for n in LEAVES:
        # An optimizer that kept no state after a step has taken nothing.
        m = st.opt.state.get(getattr(st.model, n), {}).get("exp_avg")
        st.prog_first_grad[n] = (torch.zeros_like(st.codes[n]) if m is None
                                 else m / (1 - b1))
    run(st, steps=CHECKED_STEPS - 1)
    st.prog_change = {n: float(torch.linalg.norm(
        getattr(st.model, n).detach() - st.codes[n])) for n in LEAVES}
    st.prog_losses = list(st.losses[:CHECKED_STEPS])
    st.checked_views = [st.traffic["order"](k) for k in range(CHECKED_STEPS)]
    # Warm the rest: every view once more, so the live budget has grown
    # to the views' largest before the window.
    run(st, steps=len(st.cams) + ctx.spec.get("extra_warm_steps", 4))
    return st


def _guard(st, sig):
    """budget_check's accept on the exact route (trainer.py:716-740)."""
    def grow(lt: int) -> int:
        return min(st.max_entries, -(-int(lt * 1.3 + 32768) // 65536) * 65536)

    def accept(metrics) -> bool:
        n = int(metrics["live_total"])
        cur = st.live_budget.get(sig, 0)
        if cur == 0:
            st.live_budget[sig] = grow(n)
            return True
        if n <= cur or cur == st.max_entries:
            return True
        st.live_budget[sig] = grow(n)
        return False
    return accept


def _step(st, k: int) -> tuple[int, int]:
    """The k-th iteration of train_features' exact-route loop. Returns
    (view, redone forwards)."""
    cfg = st.cfg
    v = st.traffic["order"](k)
    cam = st.cams[v]
    view, proj, campos, bg = st.trainer.camera_arrays(cam, (0, 0, 0))
    sig = (cam.image_height, cam.image_width, round(cam.tanfovx, 9),
           round(cam.tanfovy, 9))
    table, seg = st.gt[v]
    applied, redone = False, 0
    while not applied:
        settings = st.make_settings(
            cam, cfg["sh_degree"], 1.0, st.max_entries, 1024, 16,
            impl="auto", live_entries=st.live_budget.get(sig, 0))
        step = st.trainer.make_feature_train_step(settings, st.opt,
                                                  cfg["topk"], True, False,
                                                  False)
        metrics, applied = step(st.model, view, proj, campos, bg, table, seg,
                                0, accept=_guard(st, sig), device=st.dev)
        redone += not applied
    st.losses.append(float(metrics["loss"]))
    return v, redone


def run(st, seconds: float | None = None, steps: int | None = None,
        tracer=None) -> dict:
    """Steps back to back until `seconds` or `steps`; the window's end
    waits for the device."""
    dispatch, views, redone = [], [], 0
    t0 = time.perf_counter()
    n = 0
    while not (((seconds is not None and time.perf_counter() - t0 >= seconds)
                or (steps is not None and n >= steps))
               and (tracer is None or tracer.complete)):
        t_s = time.perf_counter()
        scope = (torch.profiler.record_function(trace.CALL) if tracer
                 else contextlib.nullcontext())
        with scope:
            v, r = _step(st, st.k)
        dispatch.append(time.perf_counter() - t_s)
        views.append(v)
        redone += r
        if tracer is not None:
            tracer.step(v)
        st.k += 1
        n += 1
    if st.dev.type == "cuda":
        torch.cuda.synchronize()
    return dict(attempted=n, failed=0, window_s=time.perf_counter() - t0,
                dispatch=dispatch, views=views, redone=redone)


def end_to_end(res: dict) -> dict:
    return {"steps_per_s": (res["attempted"] / res["window_s"], "steps/s")}


def release(st) -> None:
    for name in ("model", "opt", "trainer"):
        setattr(st, name, None)
    if st.dev.type == "cuda":
        torch.cuda.empty_cache()


def norm_gap(got: dict, want: dict, leaves) -> float:
    """The worst leaf's | |got| - |want| |, over the larger of that leaf's
    |want| and the median leaf's."""
    med = statistics.median(want.values())
    return max(abs(got[n] - want[n]) / max(want[n], med) for n in leaves)


def _reference(st, prec: str, fault: str | None = None) -> dict:
    act = ref_render.activate(st.scene)
    steps = [dict(cam=st.traffic["cameras"][v], table=st.traffic["tables"][v],
                  segments=st.traffic["segments"][v])
             for v in st.checked_views]
    r = feature_steps(act, st.codes["language_logits"], st.codes["codebooks"],
                      steps, st.cfg, prec, fault)
    return dict(losses=r["losses"], first_grad=r["first_grad"],
                change={n: float(torch.linalg.norm(d))
                        for n, d in r["change"].items()})


def outputs_against(st, prec: str = "f32", fault: str | None = None) -> dict:
    """The check's numbers: the program's first steps (or, with `prec` or
    `fault`, the reference's at that precision or with that fault in the
    program's place) against the reference, each by the worst leaf over
    the larger of that leaf's reference norm and the median leaf's. Leaves
    whose first gradient in the reference is under a thousandth of the
    median leaf's move by round-off alone under Adam: their change is not
    compared."""
    want = _reference(st, "f32")
    prog = (dict(losses=st.prog_losses, first_grad=st.prog_first_grad,
                 change=st.prog_change)
            if prec == "f32" and fault is None
            else _reference(st, prec, fault))
    g_want = {n: float(torch.linalg.norm(g))
              for n, g in want["first_grad"].items()}
    g_prog = {n: float(torch.linalg.norm(g))
              for n, g in prog["first_grad"].items()}
    med = statistics.median(g_want.values())
    moving = [n for n in LEAVES if g_want[n] >= 1e-3 * med]
    return {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in
                        zip(prog["losses"], want["losses"])),
        "grad_gap": norm_gap(g_prog, g_want, LEAVES),
        # The gap of norms cannot tell TF32 from f32 (its rounding
        # averages out over 64M entries); the norm of the difference can.
        "grad_diff": max(float(torch.linalg.norm(
            prog["first_grad"][n] - want["first_grad"][n]))
            / max(g_want[n], med) for n in LEAVES),
        "change_gap": norm_gap(prog["change"], want["change"], moving)}


def layer_record(st, res: dict, rec: dict, views: list) -> dict:
    """The traced steps' least seconds by layer (the reference counts each
    view's blend work) beside the trace's device seconds by kernel."""
    cfg = st.cfg
    n, K, k = cfg["n_gaussians"], cfg["codebook_size"], cfg["topk"]
    L = cfg["levels"]
    least: dict = {}
    cache = {}
    for v in views:
        if v not in cache:
            cam = st.traffic["cameras"][v]
            with torch.no_grad():
                pr = ref_render.project(ref_render.activate(st.scene), cam,
                                        cfg["sh_degree"])
                work = ref_render.count_work(pr, ref_render.entries(pr))
            gx, gy = pr["grid"]
            tiles, q = gx * gy, gx * gy * 256
            rows = st.gt[v][0].shape[0]
            cache[v] = {
                "preprocess": roofline.preprocess(n, cfg["sh_degree"]),
                "topk": roofline.topk_codes(n, L * K, k),
                "binning": roofline.binning(n, work["needed"], tiles),
                "blend": roofline.blend(work, tiles, L * K, L * k),
                "gram_fwd": roofline.gram_fwd(q, L * K, rows,
                                              cfg["clip_dim"]),
                "gram_bwd": roofline.gram_bwd(q, L * K, K, rows),
                "feature_bwd": roofline.feature_bwd(work, tiles, L * K),
                "pair_grads": roofline.pair_grads(n, L * K, L * k),
                "adam": roofline.adam(n * L * K + L * K * cfg["clip_dim"])}
        for layer, sec in cache[v].items():
            least[layer] = least.get(layer, 0.0) + sec
    return dict(calls=len(rec["calls"]), window_s=rec["window_s"],
                busy_s=rec["busy_s"], least_s=least, stage_s={},
                dispatch_s=float(np.mean(res["dispatch"])), ops=rec["ops"],
                redone=res["redone"])
