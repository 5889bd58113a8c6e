"""Cascade binning (kernel K8): depth-sorted per-tile segments without an
entry sort (port of langsplatv2_tpu/ops/pallas_cascade.py, `cascade_binning`
:411 and its `_partition_kernel` :107).

    depth sort of the N Gaussians (torch.sort, stable; JAX's lax.sort)
      -> level 0: the depth-ordered stream into tile rows
      -> level 1: each tile row into its tiles, with the exact cull

Each level is order-preserving, so each tile's segment lists its Gaussians
in (depth bits & 0x7FFFFFFF, id) order: the segments of the sort path
(`ops/expand.py`: K1 + the key sort), entry for entry, when neither
overflows. The cull is K1's (csrc/cull.cuh; `expand._cull_mask` in the
plain version). JAX's four levels and its [32, E] row stream exist because
a TPU core cannot gather; here each level moves 4-byte Gaussian ids and
the blend gathers the per-Gaussian state itself (K2 f32 on these segments
takes the place of K2's `combined` layout).

`cascade_binning` launches csrc/cascade.cu on CUDA tensors: a level is a
stable multi-bucket counting sort (totals, one scan of them, a write
pass), so a call is a zero fill, the depth keys with level 0's totals and
scan, torch.sort, the level-0 write (offsets by a decoupled look-back),
level 1's culled totals, chunk counts and scan, the chunk offsets, and the
level-1 write: LAUNCHES device launches besides the sort's own. No value
is read back to the host. On CPU tensors `cascade_binning_plain` gives
the same outputs with an expansion and a stable sort a level.

Budget: one budget, max_entries, for both levels (JAX's budget1..3 default
to its budget4). A child (tile row, tile) whose segment would end past it
is dropped with every child after it, and the overflow flag is set.
"""
from __future__ import annotations

import ctypes

import torch

from . import kernels
from .expand import _cull_mask
from .projection import ProjectedGaussians

CHUNK = 256       # items a block of the partition kernels
MAX_FAN = 1024    # tiles a side the kernels take (shared-memory counters)
MAX_BUDGET = (1 << 30) - 1   # entries: level 0's look-back words' 30 bits
LAUNCHES = 6      # device launches a call besides torch.sort's


def depth_order(depth) -> torch.Tensor:
    """Stable order of the Gaussians by depth bits & 0x7FFFFFFF (ties by
    id), as the JAX prologue sorts them (pallas_cascade.py:439-441)."""
    bits = depth.contiguous().view(torch.int32) & 0x7FFFFFFF
    return torch.sort(bits, stable=True).indices


def _bases(totals, budget: int):
    """Exclusive-scan bases of the flattened child totals; children whose
    segment ends past the budget are disabled. (bases, enabled), both
    shaped as totals."""
    flat = totals.reshape(-1)
    ends = torch.cumsum(flat, 0)
    return (ends - flat).reshape(totals.shape), (ends <= budget).reshape(
        totals.shape)


def cascade_binning_plain(proj: ProjectedGaussians, opacities, grid_x: int,
                          grid_y: int, budget: int, inv_cull_alpha: float):
    """The two levels as expansions and stable sorts; same outputs as
    `cascade_binning`."""
    dev = proj.xy.device
    order = depth_order(proj.depth)
    ids = order[proj.tiles_touched[order] > 0]
    # level 0: (Gaussian, tile row) pairs in stream order, sorted by row
    y0 = proj.rect_min[ids, 1].long()
    h = (proj.rect_max[ids, 1] - proj.rect_min[ids, 1]).long()
    pos = torch.repeat_interleave(torch.arange(ids.shape[0], device=dev), h)
    first = torch.cumsum(h, 0) - h
    rows = y0[pos] + torch.arange(pos.shape[0], device=dev) - first[pos]
    perm = torch.sort(rows, stable=True).indices
    counts0 = torch.bincount(rows, minlength=grid_y)
    _, en0 = _bases(counts0, budget)
    n0 = int((counts0 * en0).sum())
    g_rows, y_rows = ids[pos][perm][:n0], rows[perm][:n0]
    # level 1: (Gaussian, tile) pairs row by row, culled, sorted by tile
    x0 = proj.rect_min[g_rows, 0].long()
    w = (proj.rect_max[g_rows, 0] - proj.rect_min[g_rows, 0]).long()
    pos = torch.repeat_interleave(torch.arange(n0, device=dev), w)
    first = torch.cumsum(w, 0) - w
    x = x0[pos] + torch.arange(pos.shape[0], device=dev) - first[pos]
    y, g = y_rows[pos], g_rows[pos]
    keep = _cull_mask(x, y, proj.xy[g, 0], proj.xy[g, 1], proj.conic[g, 0],
                      proj.conic[g, 1], proj.conic[g, 2], opacities[g],
                      inv_cull_alpha)
    tile, g = (y * grid_x + x)[keep], g[keep]
    perm = torch.sort(tile, stable=True).indices
    counts1 = torch.bincount(tile, minlength=grid_x * grid_y)
    base1, en1 = _bases(counts1, budget)
    count = (counts1 * en1).int()
    total = count.sum(dtype=torch.int32)
    out = torch.zeros(budget, dtype=torch.int32, device=dev)
    out[:int(total)] = g[perm][:int(total)].int()
    overflow = bool((counts0 * ~en0).sum() + (counts1 * ~en1).sum() > 0)
    return (out, torch.where(en1, base1, 0).int(), count, total,
            torch.tensor(overflow, device=dev))


def workspace_plan(n: int, grid_x: int, grid_y: int, budget: int) -> dict:
    """Sizes of the CUDA path's buffers, in int32 words. chunks1 bounds
    level 1's live chunks (enabled rows hold at most `budget` items, so at
    most budget / CHUNK full chunks and one partial chunk a row): the grid
    of the level-1 passes, whose blocks past the live chunks, counted on
    the device, do no chunk. zbuf (zeroed): the rows' difference array, 3
    tickets, the tiles' totals. The workspace: a 32-byte record a
    Gaussian (first, for 16-byte alignment), keep bits [budget] (two words
    each), level 0's output [budget], the row bases, counts and chunk
    starts and level 0's overflow, the depth keys, level 0's look-back
    words and level 1's chunk counts [chunks, children]."""
    chunks0 = -(-n // CHUNK)
    chunks1 = -(-budget // CHUNK) + grid_y
    sizes = dict(gauss=8 * n, mask1=2 * budget, rows=budget,
                 meta=3 * grid_y + 2, keys=n, status0=chunks0 * grid_y,
                 counts1=chunks1 * grid_x)
    offsets, words = {}, 0
    for k, size in sizes.items():
        offsets[k] = words
        words += size
    return dict(chunks0=chunks0, chunks1=chunks1,
                zbuf=grid_y + 1 + 3 + grid_x * grid_y, words=words,
                offsets=offsets)


def cascade_binning(proj: ProjectedGaussians, opacities, grid_x: int,
                    grid_y: int, budget: int, *,
                    inv_cull_alpha: float = 255.0):
    """Per-tile depth-ordered segments of the Gaussians' culled tile
    entries. Returns (g [budget] i32 Gaussian ids, tile_start [T] i32,
    tile_count [T] i32 (row-major tiles), total [] i32 (entries kept),
    overflow [] bool). Positions of g past `total` are 0."""
    dev = proj.xy.device
    n = proj.xy.shape[0]
    if max(grid_x, grid_y) > MAX_FAN:
        raise ValueError(f"the cascade takes at most {MAX_FAN} tiles a side, "
                         f"not {grid_x}x{grid_y}")
    if dev.type == "cpu":
        return cascade_binning_plain(proj, opacities, grid_x, grid_y,
                                     budget, inv_cull_alpha)
    if dev.type != "cuda":
        raise ValueError(f"cascade_binning: unsupported device {dev}")
    for name, t, dtype, shape in (
            ("xy", proj.xy, torch.float32, (n, 2)),
            ("depth", proj.depth, torch.float32, (n,)),
            ("conic", proj.conic, torch.float32, (n, 3)),
            ("opacities", opacities, torch.float32, (n,)),
            ("rect_min", proj.rect_min, torch.int32, (n, 2)),
            ("rect_max", proj.rect_max, torch.int32, (n, 2)),
            ("tiles_touched", proj.tiles_touched, torch.int32, (n,))):
        kernels.check_tensor(t, name, dtype, shape, dev)
    if budget > MAX_BUDGET:
        raise ValueError(f"the cascade takes a budget of at most {MAX_BUDGET}"
                         f" entries, not {budget}")
    i32 = dict(dtype=torch.int32, device=dev)
    plan = workspace_plan(n, grid_x, grid_y, budget)
    zbuf = torch.zeros(plan["zbuf"], **i32)
    ws = torch.empty(plan["words"], **i32)
    g = torch.empty(budget, **i32)
    start = torch.empty(grid_x * grid_y, **i32)
    count = torch.empty(grid_x * grid_y, **i32)
    total = torch.empty((), **i32)
    overflow = torch.empty((), dtype=torch.bool, device=dev)
    P = kernels.ptr
    at = {k: ctypes.c_void_p(ws.data_ptr() + 4 * off)
          for k, off in plan["offsets"].items()}
    keys = ws[plan["offsets"]["keys"]:][:n]

    def run(stage: int, order=kernels.NULL):
        kernels.launch(
            "lsv2_cascade", stage, n, grid_x, grid_y, budget, plan["chunks1"],
            P(proj.depth), P(proj.rect_min), P(proj.rect_max),
            P(proj.tiles_touched), P(proj.xy), P(proj.conic), P(opacities),
            inv_cull_alpha, order, at["gauss"], P(zbuf), at["meta"],
            at["keys"], at["status0"], at["counts1"], at["rows"],
            at["mask1"], P(g), P(start), P(count), P(total), P(overflow),
            kernels.stream(zbuf))

    run(0)
    order = torch.sort(keys, stable=True).indices
    run(1, P(order))
    for stage in (2, 3, 4):
        run(stage)
    cascade_binning.launches += 1
    return g, start, count, total, overflow


cascade_binning.launches = 0
