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

`cascade_binning` launches csrc/cascade.cu (a count pass and a write pass
a level) on CUDA tensors; the exclusive scans of the per-chunk counts in
between are torch (JAX scans its counts in XLA, `_bases`). On CPU tensors
`cascade_binning_plain` gives the same outputs with an expansion and a
stable sort a level.

Budget: one budget, max_entries, for both levels (JAX's budget1..3 default
to its budget4). A child (tile row, tile) whose segment would end past it
is dropped with every child after it, and the overflow flag is set.
"""
from __future__ import annotations

import torch

from . import kernels
from .expand import _cull_mask
from .projection import ProjectedGaussians

CHUNK = 256       # items a block of the partition kernel
MAX_FAN = 1024    # tiles a side the kernel takes (shared-memory counters)


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


def _level_offsets(counts, chunk_first, budget: int):
    """From the count pass's [fan, chunks] counts (child-major, so that the
    scans run along rows): the write pass's offsets [fan, chunks] (int32,
    -1 for a disabled child), and the children's bases, totals and enabled
    flags [buckets, fan]."""
    dev = counts.device
    fan, n_chunks = counts.shape
    prefix = torch.zeros((fan, n_chunks + 1), dtype=torch.int64, device=dev)
    prefix[:, 1:] = torch.cumsum(counts, 1)
    cf = chunk_first.long()
    totals = (prefix[:, cf[1:]] - prefix[:, cf[:-1]]).T
    base, enabled = _bases(totals, budget)
    bucket = torch.clamp(torch.searchsorted(
        cf[1:], torch.arange(n_chunks, device=dev), right=True),
        max=totals.shape[0] - 1)
    within = prefix[:, :-1] - prefix[:, cf[bucket]]
    offsets = torch.where(enabled[bucket].T, base[bucket].T + within, -1)
    return offsets.int().contiguous(), base, totals, enabled


def _run_level(level: int, in_ids, bucket_base, bucket_count, chunk_first,
               n_chunks: int, fan: int, budget: int, proj, opacities,
               inv_cull_alpha: float):
    """Count pass, scan, write pass of one level. Returns (out [budget]
    ids, bases, totals, enabled [buckets, fan])."""
    dev = in_ids.device
    P = kernels.ptr
    counts = torch.zeros((fan, n_chunks), dtype=torch.int32, device=dev)
    out = torch.zeros(budget, dtype=torch.int32, device=dev)
    geo = (P(proj.rect_min), P(proj.rect_max), P(proj.tiles_touched),
           P(proj.xy), P(proj.conic), P(opacities), inv_cull_alpha)
    head = (P(in_ids), P(bucket_base), P(bucket_count), P(chunk_first),
            bucket_base.shape[0], fan, n_chunks, level)
    kernels.launch("lsv2_cascade_level", *head, 0, *geo, P(counts),
                   kernels.NULL, kernels.NULL, kernels.stream(counts))
    offsets, base, totals, enabled = _level_offsets(counts, chunk_first,
                                                    budget)
    kernels.check_tensor(offsets, "offsets", torch.int32, (fan, n_chunks),
                         dev)
    kernels.launch("lsv2_cascade_level", *head, 1, *geo, kernels.NULL,
                   P(offsets), P(out), kernels.stream(counts))
    return out, base, totals, enabled


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
    i32 = dict(dtype=torch.int32, device=dev)
    order = depth_order(proj.depth).int()
    c0 = -(-n // CHUNK)
    rows, base0, totals0, en0 = _run_level(
        0, order, torch.zeros(1, **i32), torch.full((1,), n, **i32),
        torch.tensor([0, c0], **i32), c0, grid_y, budget, proj, opacities,
        inv_cull_alpha)
    row_count = (totals0 * en0)[0].int()
    chunk_first = torch.zeros(grid_y + 1, **i32)
    chunk_first[1:] = torch.cumsum(-(-row_count // CHUNK), 0)
    # enabled rows hold at most `budget` items: a bound on their chunks
    c1 = -(-budget // CHUNK) + grid_y
    g, base1, totals1, en1 = _run_level(
        1, rows, base0[0].int(), row_count, chunk_first, c1, grid_x, budget,
        proj, opacities, inv_cull_alpha)
    count = (totals1 * en1).reshape(-1).int()
    overflow = ((totals0 * ~en0).sum() + (totals1 * ~en1).sum()) > 0
    cascade_binning.launches += 1
    return (g, torch.where(en1, base1, 0).reshape(-1).int(), count,
            count.sum(dtype=torch.int32), overflow)


cascade_binning.launches = 0
