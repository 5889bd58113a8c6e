"""Serving: the merged quick model's frame, as eval/lerf.py::quick_relevancy
makes it (render the 192 channels as tiles, K1 -> sort -> K2, then the
Gram query K3 and the relevancy), in a closed loop with `in_flight`
frames in flight; a frame is done when its relevancy is in host memory.

The one departure from quick_relevancy's body: its settings carry the
entry budget that the probe over the cell's own poses sets (1.07 times
the largest total, rounded up to 4,096), where quick_relevancy fixes
make_settings' 2**21, which a 1080p frame of this scene overflows.
"""
from __future__ import annotations

import contextlib
import time
from collections import deque
from types import SimpleNamespace

import numpy as np
import torch

from .. import common, roofline, trace, traffic
from ..reference import render as ref_render
from ..reference.relevancy import relevancy as ref_relevancy

# Stage marks of the frame (ops/rasterize.py and eval/openclip.py's
# mark_stage names) -> the layer they close.
LAYERS = {"start": "preprocess", "preprocess": "preprocess",
          "expand": "binning", "sort": "binning", "blend": "blend",
          "assemble": "assemble", "query": "query", "relevancy": "query"}


def setup(ctx) -> SimpleNamespace:
    from langsplatv2_tpu_torch.eval.openclip import OpenCLIPNetwork
    from langsplatv2_tpu_torch.models.gaussians import GaussianModel
    from langsplatv2_tpu_torch.models.renderer import make_settings, render

    cfg, dev = ctx.cfg, ctx.device
    st = SimpleNamespace()
    st.cfg, st.spec, st.dev, st.seed = cfg, ctx.spec, dev, ctx.seed
    st.scene = common.make_scene(cfg, ctx.seed, dev)
    st.codes = common.quick_codes(cfg, ctx.seed, dev)
    st.traffic = traffic.generate(ctx.mix, cfg, ctx.seed, dev)
    st.cams = [common.Camera(c) for c in st.traffic["cameras"]]
    st.names = [tuple(f"p{i}" for i in range(p.shape[0]))
                for p in st.traffic["prompts"]]
    st.model = GaussianModel(
        **st.scene, **st.codes, active_sh_degree=cfg["sh_degree"],
        max_sh_degree=cfg["sh_degree"])
    st.clip = OpenCLIPNetwork(backend="hash", device=dev)
    st.clip.negatives = tuple(f"n{i}" for i in range(cfg["negatives"]))
    st.clip.neg_embeds = st.traffic["negatives"]
    st.render = render
    # The entry budget: probe every pose of the cell at a budget no frame
    # fills, then 1.07 times the largest total.
    probe = ctx.spec["probe_entries"]
    totals = []
    with torch.no_grad():
        for cam in st.cams:
            s = make_settings(cam, cfg["sh_degree"], max_entries=probe)
            out = render(s._replace(assemble=False), st.model,
                         cam.world_view_transform, cam.full_proj_transform,
                         cam.camera_center, torch.zeros(3, device=dev),
                         quick_render=True, device=dev)
            totals.append(int(out.total_entries))
            del out
    if max(totals) >= probe:
        raise RuntimeError(f"the probe budget {probe} is full "
                           f"({max(totals)} entries)")
    st.max_entries = -(-int(max(totals) * 1.07) // 4096) * 4096
    st.settings = [make_settings(cam, cfg["sh_degree"],
                                 max_entries=st.max_entries)._replace(
                                     assemble=False) for cam in st.cams]
    n_sample = ctx.spec["sample_frames"]
    st.in_flight = st.traffic["in_flight"]
    size = max(cfg["levels"] * p.shape[0] for p in
               st.traffic["prompts"]) * st.cams[0].image_height \
        * st.cams[0].image_width
    st.pool = [torch.empty(size, pin_memory=dev.type == "cuda")
               for _ in range(st.in_flight + n_sample + 1)]
    st.rng = np.random.default_rng([int(ctx.seed), 13])
    st.k = 0
    # Warm every shape of the traffic: one pass over its views.
    run(st, frames=max(len(st.cams), 2 * (st.in_flight + n_sample)))
    return st


def _frame(st, k: int, stage_events):
    """quick_relevancy's body for the k-th frame of the traffic."""
    v = st.traffic["order"](k)
    cam, clip = st.cams[v], st.clip
    clip.positives = st.names[v]
    clip.pos_embeds = st.traffic["prompts"][v]
    s = st.settings[v]
    bg = torch.zeros(3, device=st.dev)
    with torch.no_grad():
        out = st.render(s, st.model, cam.world_view_transform,
                        cam.full_proj_transform, cam.camera_center, bg,
                        quick_render=True, device=st.dev,
                        stage_events=stage_events)
        relev = clip.relevancy_from_tiles(
            out.language_feature_weight_map,
            *clip.prompt_constants(st.model.codebooks), s.grid_x, s.grid_y,
            s.image_height, s.image_width, stage_events=stage_events)
    return v, relev, out


def run(st, seconds: float | None = None, frames: int | None = None,
        tracer=None) -> dict:
    """The closed loop: dispatch a frame, then finish the oldest once
    `in_flight` are out. Stops dispatching after `seconds` or `frames`,
    then finishes every frame in flight. Keeps a reservoir sample (drawn
    from the seed) of the finished frames' outputs for the check."""
    cuda = st.dev.type == "cuda"
    n_sample = st.spec["sample_frames"]
    inflight = deque()
    latency, dispatch, views = [], [], []
    for smp in getattr(st, "samples", []):
        st.pool.append(smp["buf"])
    st.samples, done = [], 0

    def finish(item):
        nonlocal done
        k, v, t_s, ev, buf, host, out = item
        if ev is not None:
            ev.synchronize()
        latency.append(time.perf_counter() - t_s)
        keep = dict(view=v, relev=host, buf=buf,
                    feat=out.language_feature_weight_map, rgb=out.render,
                    total=out.total_entries)
        if done < n_sample:
            st.samples.append(keep)
        else:
            j = int(st.rng.integers(0, done + 1))
            if j < n_sample:
                st.pool.append(st.samples[j]["buf"])
                st.samples[j] = keep
            else:
                st.pool.append(buf)
        done += 1

    t0 = time.perf_counter()
    n = 0
    while True:
        if ((seconds is not None and time.perf_counter() - t0 >= seconds)
                or (frames is not None and n >= frames)) \
                and (tracer is None or tracer.complete):
            break
        t_s = time.perf_counter()
        scope = (torch.profiler.record_function(trace.CALL) if tracer
                 else contextlib.nullcontext())
        with scope:
            # The stage marks are CUDA events: none on the CPU.
            v, relev, out = _frame(st, st.k, trace.StageLog()
                                   if tracer and cuda else None)
            buf = st.pool.pop()
            host = buf[:relev.numel()].view(relev.shape)
            host.copy_(relev, non_blocking=cuda)
            ev = None
            if cuda:
                ev = torch.cuda.Event()
                ev.record()
        dispatch.append(time.perf_counter() - t_s)
        inflight.append((st.k, v, t_s, ev, buf, host, out))
        del relev, out
        views.append(v)
        if len(inflight) >= st.in_flight:
            finish(inflight.popleft())
        if tracer is not None:
            tracer.step(v)
        st.k += 1
        n += 1
    while inflight:
        finish(inflight.popleft())
    return dict(attempted=n, failed=0, window_s=time.perf_counter() - t0,
                latency=latency, dispatch=dispatch, views=views)


def end_to_end(res: dict) -> dict:
    return {"frames_per_s": (res["attempted"] / res["window_s"], "frames/s"),
            "frame_p95_ms": (1e3 * float(np.percentile(res["latency"], 95)),
                             "ms")}


def release(st) -> None:
    """Free the program's state; keep the inputs and the sampled outputs."""
    for name in ("model", "clip", "settings", "pool"):
        setattr(st, name, None)
    if st.dev.type == "cuda":
        torch.cuda.empty_cache()


def _reference(st, v: int, prec: str):
    cfg = st.cfg
    cam = st.traffic["cameras"][v]
    with torch.no_grad():
        act = ref_render.activate(st.scene)
        pr = ref_render.project(act, cam, cfg["sh_degree"])
        ent = ref_render.entries(pr)
        b = ref_render.blend(pr, ent, st.codes["quick_weights"],
                             st.codes["quick_indices"],
                             cfg["levels"] * cfg["codebook_size"], prec)
    return pr, b


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b||, in f64."""
    a, b = a.double(), b.double()
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def outputs_against(st, prec: str = "f32") -> dict:
    """The check's numbers, the worst over the sampled frames: the
    program's outputs (with `prec` other than "f32": the reference's at
    that precision, the control) against the reference."""
    cfg = st.cfg
    worst = {"feat_rel_err": 0.0, "rgb_rel_err": 0.0, "relev_rel_err": 0.0}
    for smp in st.samples:
        v = smp["view"]
        cam = st.traffic["cameras"][v]
        h, w = cam["height"], cam["width"]
        _pr, b = _reference(st, v, "f32")
        gx, gy = -(-w // 16), -(-h // 16)
        inside = ref_render.image_to_tiles(
            torch.ones((h, w), dtype=torch.bool, device=st.dev), gx, gy,
            fill=False)
        got = {"feat": smp["feat"].float(), "rgb": smp["rgb"],
               "relev": smp["relev"].to(st.dev)}
        if prec != "f32":
            _pr, b_low = _reference(st, v, prec)
            low_relev = ref_relevancy(
                b_low["feat"], st.codes["codebooks"],
                st.traffic["prompts"][v], st.traffic["negatives"],
                (gx, gy), h, w, prec)
            got = {"feat": b_low["feat"],
                   "rgb": ref_render.tiles_to_image(b_low["rgb"], gx, gy,
                                                    h, w),
                   "relev": low_relev}
        want_relev = ref_relevancy(
            b["feat"], st.codes["codebooks"], st.traffic["prompts"][v],
            st.traffic["negatives"], (gx, gy), h, w, "f32")
        nums = {
            "feat_rel_err": rel_err(got["feat"][inside], b["feat"][inside]),
            "rgb_rel_err": rel_err(got["rgb"], ref_render.tiles_to_image(
                b["rgb"], gx, gy, h, w)),
            "relev_rel_err": rel_err(got["relev"], want_relev)}
        for k, x in nums.items():
            worst[k] = max(worst[k], x)
    return worst


def layer_record(st, res: dict, rec: dict, views: list) -> dict:
    """The traced run's per-layer numbers: device seconds by layer over the
    traced frames, and the least seconds of their work, which the
    reference counts for the frames' poses."""
    cfg = st.cfg
    frames = rec["calls"]
    stage_s: dict = {}
    for c in frames:
        for stage, sec in c.items():
            layer = LAYERS.get(stage, stage)
            stage_s[layer] = stage_s.get(layer, 0.0) + sec
    least: dict = {}
    cache = {}
    L, K = cfg["levels"], cfg["codebook_size"]
    for v in views:
        if v not in cache:
            cam = st.traffic["cameras"][v]
            h, w = cam["height"], cam["width"]
            with torch.no_grad():
                pr = ref_render.project(ref_render.activate(st.scene), cam,
                                        cfg["sh_degree"])
                work = ref_render.count_work(pr, ref_render.entries(pr))
            gx, gy = pr["grid"]
            tiles = gx * gy
            cache[v] = {
                "preprocess": roofline.preprocess(cfg["n_gaussians"],
                                                  cfg["sh_degree"]),
                "binning": roofline.binning(cfg["n_gaussians"],
                                            work["needed"], tiles),
                "blend": roofline.blend(work, tiles, L * K, L * cfg["topk"]),
                "assemble": roofline.assemble(tiles, h, w),
                "query": roofline.query(
                    tiles, L, K, st.traffic["prompts"][v].shape[0],
                    cfg["negatives"], h, w, cfg["clip_dim"])}
        for layer, sec in cache[v].items():
            least[layer] = least.get(layer, 0.0) + sec
    return dict(calls=len(frames), window_s=rec["window_s"],
                busy_s=rec["busy_s"], stage_s=stage_s, least_s=least,
                dispatch_s=float(np.mean(res["dispatch"])), ops=rec["ops"])
