"""Training: the geometry phase (LangSplatV2's Stage B), one iteration at a
time through train/trainer.py::rgb_iteration, the loop body train_rgb
runs: the step (render with the means2D carrier, preprocess under
autograd -> K1 -> sort -> K2; L1 + SSIM; the backward through K7 and the
preprocess; the dead-row mask, the scheduled rates and Adam over six
groups; the densification statistics), then the densify and
opacity-reset schedule.

The replay. Set-up makes the views (traffic.poses, common.camera), the
scene, its targets and the extent (the port's nerf++ rule over the
views), primes Adam at step first - 33 with zero moments, and runs the 32
iterations before the replay (every view once, the last one iteration
3500's round); then it snapshots the model, Adam's moments and step and
the capacity. The window replays iterations first..last (3501-3700:
rounds at 3600 and 3700, no reset) from that snapshot again and again,
re-seeding the split noise and the camera order each time, so every
replay does the same work: a faster program does not densify the scene
further in the same window. The restore is inside the window.

The targets are no-grad renders (the program's) of a seeded truth copy
of the scene: positions moved by up to `truth.jitter` of the Gaussian's
own scale on each axis, DC colours and opacities drawn anew.

The entry budget is probed over the views (the targets' scene and the
trained one) and set `entry_margin` times the largest total, rounded up
to 4,096, where train_rgb takes 2**21 by default; a step whose total
reaches it counts as failed.

The check (outputs_against): the window's first replay's first 3 steps
against reference/geometry.py from the snapshot (the first gradient as
`.grad` holds it after step 1, the means2D carrier's too, and the change
after step 3), and its first round against the reference's round over
the program's own statistics and split noise, the live sets compared
regardless of slot order.
"""
from __future__ import annotations

import contextlib
import statistics
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from .. import common, roofline_geometry as rg, trace, traffic
from ..reference import geometry as ref
from ..reference import render as ref_render
from .feature_step import norm_gap

CHECKED_STEPS = 3
GRADS = ref.LEAVES + ("means2d",)
FIELDS = ref.LEAVES
STATE = ("live", "xyz_gradient_accum", "denom")


def extent(views: list) -> float:
    """The port's nerf++ rule (scene/dataset.py get_nerfpp_norm) over the
    views' cameras: 1.1 times the largest distance of a centre from their
    mean."""
    from langsplatv2_tpu_torch.scene.dataset import get_nerfpp_norm

    # view is the transposed world-to-view matrix: its rotation block is
    # the camera-to-world rotation (3DGS's R), its last row the
    # translation T.
    infos = [SimpleNamespace(R=np.asarray(v["view"], np.float64)[:3, :3],
                             T=np.asarray(v["view"], np.float64)[3, :3])
             for v in views]
    return get_nerfpp_norm(infos)["radius"]


def truth(scene: dict, cfg: dict, seed: int, device) -> dict:
    """The scene the targets show: each position moved by up to `jitter`
    of the Gaussian's own scale on each axis, DC colours and opacities
    drawn anew."""
    g = common.generator(seed, device, 6)
    n = scene["xyz"].shape[0]
    u = torch.rand((n, 7), generator=g, device=device)
    lo, hi = cfg["scene"]["opacity_range"]
    op = lo + (hi - lo) * u[:, 6:7]
    return dict(
        scene,
        xyz=scene["xyz"] + cfg["truth"]["jitter"]
        * torch.exp(scene["scaling"]) * (2.0 * u[:, 0:3] - 1.0),
        features_dc=((u[:, 3:6] - 0.5) / common.SH_C0)[:, None, :],
        opacity=torch.log(op / (1.0 - op)))


def padded(scene: dict, capacity: int) -> dict:
    """The scene's fields in `capacity` slots, the rest dead: zero, with
    identity rotations, and the live mask."""
    n = scene["xyz"].shape[0]
    out = {}
    for k, v in scene.items():
        out[k] = torch.cat([v, v.new_zeros((capacity - n,) + v.shape[1:])])
    out["rotation"][n:, 0] = 1.0
    out["live"] = torch.arange(capacity, device=out["xyz"].device) < n
    return out


def setup(ctx) -> SimpleNamespace:
    from langsplatv2_tpu_torch.models.gaussians import GaussianModel
    from langsplatv2_tpu_torch.models.renderer import make_settings, render
    from langsplatv2_tpu_torch.train import trainer

    if not hasattr(trainer, "rgb_iteration"):
        raise RuntimeError("this program has no train/trainer.py "
                           "rgb_iteration, which the cell drives")
    cfg, mix, dev = ctx.cfg, ctx.mix, ctx.device
    st = SimpleNamespace(cfg=cfg, mix=mix, spec=ctx.spec, dev=dev,
                         seed=ctx.seed, trainer=trainer,
                         GaussianModel=GaussianModel)
    st.views = [common.camera(yaw, c, mix["width"], mix["height"], cfg)
                for yaw, c in traffic.poses(mix)]
    st.cams = [common.Camera(v) for v in st.views]
    st.extent = extent(st.views)
    lr = cfg["lr"]
    st.opt = SimpleNamespace(
        position_lr_init=lr["position_init"],
        position_lr_final=lr["position_final"],
        position_lr_delay_mult=lr["position_delay_mult"],
        position_lr_max_steps=lr["position_max_steps"],
        feature_lr=lr["feature"], opacity_lr=lr["opacity"],
        scaling_lr=lr["scaling"], rotation_lr=lr["rotation"],
        **{k: cfg[k] for k in (
            "lambda_dssim", "percent_dense", "densify_grad_threshold",
            "densification_interval", "opacity_reset_interval",
            "densify_from_iter", "densify_until_iter")})
    deg, cap = cfg["sh_degree"], cfg["capacity"]
    scene = common.make_scene(cfg, ctx.seed, dev)
    model = GaussianModel(**padded(scene, cap), active_sh_degree=deg,
                          max_sh_degree=deg, spatial_lr_scale=st.extent)
    shown = GaussianModel(**padded(truth(scene, cfg, ctx.seed, dev), cap),
                          active_sh_degree=deg, max_sh_degree=deg)
    del scene
    # The targets, and the entry budget from both scenes' totals.
    probe = ctx.spec["probe_entries"]
    bg = np.asarray(cfg["background"], np.float32)
    st.targets, totals = [], []
    with torch.no_grad():
        for cam in st.cams:
            s = make_settings(cam, deg, max_entries=probe)
            for m in (model, shown):
                out = render(s, m, cam.world_view_transform,
                             cam.full_proj_transform, cam.camera_center, bg,
                             device=dev)
                totals.append(int(out.total_entries))
            st.targets.append(out.render.contiguous())
            del out
    del shown
    if max(totals) >= probe:
        raise RuntimeError(f"the probe budget {probe} is full "
                           f"({max(totals)} entries)")
    st.max_entries = -(-int(max(totals) * ctx.spec["entry_margin"])
                       // 4096) * 4096
    # Adam primed so that the iterations before the replay end at step
    # first - 1, then those iterations.
    first = cfg["replay"]["first"]
    n_views = len(st.views)
    st.model = model
    st.optimizer = trainer.make_rgb_optimizer(st.opt, model)
    for group in st.optimizer.param_groups:
        (p,) = group["params"]
        st.optimizer.state[p] = {
            "step": torch.tensor(float(first - 1 - n_views)),
            "exp_avg": torch.zeros_like(p), "exp_avg_sq": torch.zeros_like(p)}
    st.generator = common.generator(ctx.seed, dev, 7)
    st.logs = trainer.TrainLogs()
    st.capture = None
    st.overflows = torch.zeros((), dtype=torch.int64, device=dev)
    warm_order = traffic.make_order(mix["order"], n_views, ctx.seed + 1)
    for j in range(n_views):
        _iteration(st, first - n_views + j, warm_order(j))
    if st.model.capacity != cap or int(st.overflows):
        raise RuntimeError(f"before the replay the capacity grew to "
                           f"{st.model.capacity} or a step filled the "
                           f"entry budget {st.max_entries}")
    st.snapshot = dict(
        fields={k: getattr(st.model, k).detach().clone()
                for k in FIELDS + STATE},
        moments={g["name"]: {k: v.clone() for k, v in
                             st.optimizer.state[g["params"][0]].items()}
                 for g in st.optimizer.param_groups})
    st.logs.events.clear()
    st.restore_s, st.capture, st.want = [], {}, None
    restore(st)
    st.checked_views = [st.order(k) for k in range(CHECKED_STEPS)]
    return st


def restore(st) -> None:
    """The snapshot as a new model and optimizer (Adam's moments and step
    copied), the split noise's generator and the camera order re-seeded;
    the next iteration is the replay's first."""
    snap = st.snapshot
    deg = st.cfg["sh_degree"]
    st.model = st.GaussianModel(
        **{k: v.clone() for k, v in snap["fields"].items()},
        active_sh_degree=deg, max_sh_degree=deg, spatial_lr_scale=st.extent)
    st.optimizer = st.trainer.make_rgb_optimizer(st.opt, st.model)
    for group in st.optimizer.param_groups:
        st.optimizer.state[group["params"][0]] = {
            k: v.clone() for k, v in snap["moments"][group["name"]].items()}
    st.generator = common.generator(st.seed, st.dev, 8)
    st.order = traffic.make_order(st.mix["order"], len(st.views), st.seed)
    st.k = 0


def is_round(cfg: dict, it: int) -> bool:
    """Whether iteration `it` ends with a densification round."""
    return (it % cfg["densification_interval"] == 0
            and cfg["densify_from_iter"] < it < cfg["densify_until_iter"])


def _iteration(st, it: int, v: int) -> None:
    """rgb_iteration `it` on view v. In the window's first replay (once
    `st.capture` is a dict) what the check reads is kept: copies on the
    device, no read to the host."""
    cfg, cap = st.cfg, st.capture
    first_round = cap is not None and "round" not in cap \
        and is_round(cfg, it)
    if first_round:
        # The model object before the round keeps its tensors: the round
        # makes new ones.
        cap["round"] = dict(pre=st.model, noise=st.generator.get_state(),
                            size_threshold=it > cfg["opacity_reset_interval"])
    st.model, metrics = st.trainer.rgb_iteration(
        it, st.model, st.optimizer, st.cams[v], st.targets[v], st.opt,
        st.extent, st.generator, st.logs, iterations=cfg["iterations"],
        bg_color=cfg["background"], max_entries=st.max_entries,
        device=st.dev)
    st.overflows += (metrics["total_entries"] >= st.max_entries).long()
    if cap is None:
        return
    if first_round:
        cap["round"]["post"] = {k: getattr(st.model, k).detach().clone()
                                for k in FIELDS + ("live",)}
    if "change" not in cap:
        if st.k == 0:
            cap["grad"] = {k: getattr(st.model, k).grad.clone()
                           for k in FIELDS}
            cap["grad"]["means2d"] = metrics["means2d_grad"].clone()
            cap["losses"] = []
        cap["losses"].append(st.logs.losses[-1])
        if st.k == CHECKED_STEPS - 1:
            cap["change"] = {k: getattr(st.model, k).detach()
                             - st.snapshot["fields"][k] for k in FIELDS}


def run(st, seconds: float | None = None, steps: int | None = None,
        tracer=None) -> dict:
    """Iterations back to back until `seconds` or `steps` (and at least
    until the first round has run); the window's end waits for the
    device."""
    first, last = st.cfg["replay"]["first"], st.cfg["replay"]["last"]
    dispatch, views, tags = [], [], []
    t0 = time.perf_counter()
    n = 0
    while not (((seconds is not None and time.perf_counter() - t0 >= seconds)
                or (steps is not None and n >= steps))
               and (tracer is None or tracer.complete)
               and "post" in st.capture.get("round", {})):
        if st.k > last - first:
            t_r = time.perf_counter()
            restore(st)
            st.restore_s.append(time.perf_counter() - t_r)
        it, v = first + st.k, st.order(st.k)
        t_s = time.perf_counter()
        scope = (torch.profiler.record_function(trace.CALL) if tracer
                 else contextlib.nullcontext())
        with scope:
            _iteration(st, it, v)
        dispatch.append(time.perf_counter() - t_s)
        views.append(v)
        tags.append(it)
        if tracer is not None:
            tracer.step((it, v))
        st.k += 1
        n += 1
    if st.dev.type == "cuda":
        torch.cuda.synchronize()
    failed = int(st.overflows)
    print(f"geometry_step: {n} iterations, {len(st.restore_s)} restores "
          f"({1e3 * statistics.mean(st.restore_s or [0.0]):.3f} ms mean, "
          f"host clock), the first rounds (iteration, event, live) "
          f"{st.logs.events[:2]}", file=sys.stderr, flush=True)
    return dict(attempted=n, failed=failed,
                window_s=time.perf_counter() - t0, dispatch=dispatch,
                views=views, iterations=tags)


def end_to_end(res: dict) -> dict:
    return {"steps_per_s": (res["attempted"] / res["window_s"], "steps/s")}


def release(st) -> None:
    for name in ("model", "optimizer", "trainer"):
        setattr(st, name, None)
    if st.dev.type == "cuda":
        torch.cuda.empty_cache()


def _live_rows(t: dict, live: torch.Tensor, keys) -> dict:
    return {k: t[k][live] for k in keys}


def _reference_steps(st, prec: str, fault: str | None) -> dict:
    snap = st.snapshot
    live = snap["fields"]["live"]
    raw0 = _live_rows(snap["fields"], live, FIELDS)
    moments0 = {k: (snap["moments"][k]["exp_avg"][live],
                    snap["moments"][k]["exp_avg_sq"][live]) for k in FIELDS}
    step0 = int(snap["moments"]["xyz"]["step"])
    steps = [dict(cam=st.views[v], gt=st.targets[v])
             for v in st.checked_views]
    r = ref.geometry_steps(raw0, moments0, step0, steps, st.cfg, st.extent,
                           prec, fault)
    return dict(losses=r["losses"], first_grad=r["first_grad"],
                change=r["change"])


def _reference_round(st) -> dict:
    """The reference's round over the program's pre-round state,
    statistics and split noise (drawn again from the generator's state as
    run_densify draws it)."""
    rnd = st.capture["round"]
    pre = rnd["pre"]
    g = torch.Generator(device=st.dev)
    g.set_state(rnd["noise"])
    eps = torch.randn((2, pre.capacity, 3), generator=g,
                      device=g.device).to(pre.xyz.device)
    live = pre.live
    fields = {k: getattr(pre, k).detach()[live] for k in FIELDS}
    return ref.densify_round(fields, pre.xyz_gradient_accum[live, 0],
                             pre.denom[live, 0], eps[:, live], st.extent,
                             st.cfg, rnd["size_threshold"])


def set_gap(got: dict, want: dict) -> float:
    """Two sets of Gaussians compared regardless of order: 1 + the share
    of rows by which their counts differ; else the worst column's
    |sorted got - sorted want| over |want| (sorting a column alone moves
    no value by more than the largest change of one)."""
    n_got = next(iter(got.values())).shape[0]
    n_want = next(iter(want.values())).shape[0]
    if n_got != n_want:
        return 1.0 + abs(n_got - n_want) / max(n_want, 1)
    worst = 0.0
    for k in want:
        a = torch.sort(got[k].reshape(n_got, -1), dim=0).values
        b = torch.sort(want[k].reshape(n_want, -1), dim=0).values
        worst = max(worst, float(torch.linalg.norm(a - b))
                    / max(float(torch.linalg.norm(b)), 1e-30))
    return worst


def outputs_against(st, prec: str = "f32", fault: str | None = None) -> dict:
    """The check's numbers: the program's first steps and first round
    (or, with `prec` or `fault`, the reference's at that precision or
    with that fault in the program's place: fault "unchanged" applies no
    update and no round) against the reference. The gradients and changes
    are compared on the snapshot's live rows, each leaf's over the larger
    of its reference norm and the median leaf's; leaves whose first
    gradient is under a thousandth of the median leaf's move by round-off
    alone under Adam: their change is not compared."""
    if st.want is None:
        st.want = dict(_reference_steps(st, "f32", None),
                       round=_reference_round(st))
    want = st.want
    live = st.snapshot["fields"]["live"]
    cap = st.capture
    if prec == "f32" and fault is None:
        prog = dict(losses=cap["losses"],
                    first_grad=_live_rows(cap["grad"], live, GRADS),
                    change=_live_rows(cap["change"], live, FIELDS),
                    round=_live_rows(cap["round"]["post"],
                                     cap["round"]["post"]["live"], FIELDS))
    else:
        prog = _reference_steps(st, prec, fault)
        pre = cap["round"]["pre"]
        prog["round"] = ({k: getattr(pre, k).detach()[pre.live]
                          for k in FIELDS} if fault == "unchanged"
                         else want["round"])
    g_want = {n: float(torch.linalg.norm(want["first_grad"][n]))
              for n in GRADS}
    g_prog = {n: float(torch.linalg.norm(prog["first_grad"][n]))
              for n in GRADS}
    c_want = {n: float(torch.linalg.norm(want["change"][n])) for n in FIELDS}
    c_prog = {n: float(torch.linalg.norm(prog["change"][n])) for n in FIELDS}
    med = statistics.median(g_want.values())
    moving = [n for n in FIELDS if g_want[n] >= 1e-3 * med]
    return {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in
                        zip(prog["losses"], want["losses"])),
        "grad_gap": norm_gap(g_prog, g_want, GRADS),
        "grad_diff": max(float(torch.linalg.norm(
            prog["first_grad"][n] - want["first_grad"][n]))
            / max(g_want[n], med) for n in GRADS),
        "change_gap": norm_gap(c_prog, c_want, moving),
        "densify_gap": set_gap(prog["round"], want["round"])}


def layer_record(st, res: dict, rec: dict, tags: list) -> dict:
    """The traced steps' least seconds by stage (the reference counts each
    view's blend work on the snapshot's Gaussians) and the traced rounds',
    beside the trace's device seconds by kernel."""
    cfg, cap = st.cfg, st.cfg["capacity"]
    deg = cfg["sh_degree"]
    snap = st.snapshot["fields"]
    act = ref_render.activate(_live_rows(snap, snap["live"], FIELDS))
    least: dict = {}
    cache = {}
    rounds = 0
    for it, v in tags:
        if v not in cache:
            cam = st.views[v]
            with torch.no_grad():
                pr = ref_render.project(act, cam, deg)
                work = ref_render.count_work(pr, ref_render.entries(pr))
            gx, gy = pr["grid"]
            tiles = gx * gy
            cache[v] = {
                "preprocess": rg.preprocess_fwd(cap, deg),
                "binning": rg.roofline.binning(cap, work["needed"], tiles),
                "blend": rg.blend(work, tiles),
                "loss": rg.loss(cam["height"], cam["width"]),
                "rgb_bwd": rg.rgb_bwd(work, tiles),
                "reduce": rg.reduce(work, cap),
                "preprocess_bwd": rg.preprocess_bwd(cap, deg),
                "adam": rg.adam(cap, deg)}
        for layer, sec in cache[v].items():
            least[layer] = least.get(layer, 0.0) + sec
        if is_round(cfg, it):
            rounds += 1
            least["densify"] = least.get("densify", 0.0) + rg.densify(cap,
                                                                      deg)
    return dict(calls=len(rec["calls"]), window_s=rec["window_s"],
                busy_s=rec["busy_s"], least_s=least, stage_s={},
                dispatch_s=float(np.mean(res["dispatch"])), ops=rec["ops"],
                rounds=rounds)
