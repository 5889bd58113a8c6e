"""The one traffic generator: it reads a mix's data file
(`portbench/traffic/<name>.json`) and makes its views, prompts and
training targets from the run's seed. The program receives only what
this returns.

A mix's keys:
  mode        "frames" (served views, a closed loop of `in_flight`
              frames) or "steps" (training views, steps back to back)
  width, height, views
  path        "orbit": a closed path of `views` poses;
              "scatter": `views` poses stratified over the yaw and
              translation ranges.
              Both are fixed designs: every seed serves the same poses and
              the same sizes (prompt and segment counts a view), in
              another order, so that a seed changes the values and not
              the work
  yaw_deg, translate   the yaw and translation ranges (+-)
  positives   [lo, hi]: positive prompts a view, spread evenly over the
              range and shuffled; the configuration's negatives join them
  in_flight   frames in flight (frames mode)
  segments    [lo, hi]: segments a training view (steps mode)
  unlabeled_share      share of a training view's pixels at -1
  order       "cycle" (the path from a seeded starting view),
              "shuffled" (a seeded permutation of the views, repeated) or
              "trainer" (the feature trainer's pick: a stack refilled with
              every view, popped at random.Random(seed).randint)
"""
from __future__ import annotations

import math
import random

import numpy as np
import torch

from . import common


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.norm(x, dim=-1, keepdim=True)


# The design's own draws (phases of the orbit, strata of the scatter, the
# counts' assignment to views): fixed, not the run's seed.
DESIGN = 20260521


def poses(mix: dict) -> list[tuple[float, np.ndarray]]:
    """(yaw in degrees, centre) of each view."""
    rng = np.random.default_rng(DESIGN)
    n, Y, t = mix["views"], mix["yaw_deg"], mix["translate"]
    if mix["path"] == "orbit":
        ph = rng.uniform(0.0, 2 * math.pi, 4)
        out = []
        for k in range(n):
            u = 2 * math.pi * k / n
            c = t * np.array([math.sin(u + ph[1]), math.sin(2 * u + ph[2]),
                              math.sin(u + ph[3])])
            out.append((Y * math.sin(u + ph[0]), c))
        return out
    if mix["path"] == "scatter":
        strata = [(rng.permutation(n) + 0.5) / n * 2.0 - 1.0
                  for _ in range(4)]
        return [(Y * strata[0][k],
                 t * np.array([strata[1][k], strata[2][k], strata[3][k]]))
                for k in range(n)]
    raise ValueError(f"unknown path {mix['path']!r}")


def spread(lo: int, hi: int, n: int, rng) -> np.ndarray:
    """n whole numbers spread evenly over [lo, hi], shuffled."""
    return rng.permutation(lo + (np.arange(n) * (hi - lo + 1)) // n)


def voronoi_segments(h: int, w: int, n_seg: int, unlabeled: float,
                     g: torch.Generator, device) -> torch.Tensor:
    """[h, w] int32 segment ids: the nearest of n_seg seeded sites; whole
    segments drawn at random are set to -1 until `unlabeled` of the
    pixels are (SAM leaves regions unlabeled, not single pixels)."""
    sites = torch.rand((n_seg, 2), generator=g, device=device) \
        * torch.tensor([w, h], device=device)
    ys, xs = torch.meshgrid(torch.arange(h, device=device),
                            torch.arange(w, device=device), indexing="ij")
    pix = torch.stack([xs, ys], -1).reshape(-1, 2).float()
    seg = torch.empty(h * w, dtype=torch.int64, device=device)
    for s in range(0, h * w, 1 << 16):
        seg[s:s + (1 << 16)] = torch.cdist(pix[s:s + (1 << 16)],
                                           sites).argmin(1)
    area = torch.bincount(seg, minlength=n_seg)
    order = torch.randperm(n_seg, generator=g, device=device)
    cum = torch.cumsum(area[order], 0)
    k = int(torch.searchsorted(cum, torch.tensor(unlabeled * h * w,
                                                 device=device))) + 1
    drop = torch.zeros(n_seg, dtype=torch.bool, device=device)
    drop[order[:k]] = True
    seg = torch.where(drop[seg], -1, seg)
    return seg.reshape(h, w).int()


def generate(mix: dict, cfg: dict, seed: int, device) -> dict:
    """The mix's inputs: `cameras` (common.camera dicts), and for frames
    `prompts` (a [P, D] unit tensor a view) and `negatives` [N, D]; for
    steps `tables` ([S, D] unit GT rows a view) and `segments` ([H, W]
    int32 a view). `order(k)` gives the view of the k-th frame or step."""
    design = np.random.default_rng(DESIGN + 1)
    g = common.generator(seed, device, 4)
    n, W, H = mix["views"], mix["width"], mix["height"]
    out = dict(mode=mix["mode"], cameras=[
        common.camera(yaw, c, W, H, cfg) for yaw, c in poses(mix)])
    D = cfg["clip_dim"]
    if mix["mode"] == "frames":
        counts = spread(*mix["positives"], n, design)
        out["negatives"] = _unit(torch.randn(
            (cfg["negatives"], D), generator=g, device=device))
        out["prompts"] = [_unit(torch.randn((int(p), D), generator=g,
                                            device=device)) for p in counts]
        out["in_flight"] = mix["in_flight"]
    elif mix["mode"] == "steps":
        counts = spread(*mix["segments"], n, design)
        out["segments"] = [voronoi_segments(H, W, int(s),
                                            mix["unlabeled_share"], g,
                                            device) for s in counts]
        out["tables"] = [_unit(torch.randn((int(s), D), generator=g,
                                           device=device)) for s in counts]
    else:
        raise ValueError(f"unknown mode {mix['mode']!r}")
    out["order"] = make_order(mix["order"], n, seed)
    return out


def make_order(kind: str, n: int, seed: int):
    """k -> the view of the k-th frame or step (k counts from 0 and must
    be asked for in increasing order for "trainer")."""
    if kind == "cycle":
        start = int(seed) % n
        return lambda k: (start + k) % n
    if kind == "shuffled":
        perm = np.random.default_rng([int(seed), 12]).permutation(n)
        return lambda k: int(perm[k % n])
    if kind != "trainer":
        raise ValueError(f"unknown order {kind!r}")
    rng, stack, picked = random.Random(seed), [], []

    def order(k: int) -> int:
        while len(picked) <= k:
            if not stack:
                stack.extend(range(n))
            picked.append(stack.pop(rng.randint(0, len(stack) - 1)))
        return picked[k]
    return order
