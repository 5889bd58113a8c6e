"""K8's budget and shape edges on the CPU: the port's plain cascade
(`ops/cascade.py::cascade_binning_plain`, which the kernel is held to on the
card) against the JAX package's cascade semantics, and the CUDA path's
host-side plan.

One call of JAX's `cascade_binning` in interpret mode compiles for about a
minute a budget and grid (tests/test_torch_port_cascade.py makes one, on a
scene that does not overflow). Its budgets count 128- and 256-aligned
segments, where the port's count entries. So the reference here is
assembled from JAX's own pieces of that function, on the port's unaligned
budget: the depth order (`lax.sort` of depth bits & 0x7FFFFFFF, stable),
the exact cull (`pallas_cascade._tile_cull_pass`) and the budget rule
(`pallas_cascade._bases` at alignment 1: a child whose segment ends past the
budget is disabled with every child after it, the overflow flag covers both
levels). The scenes are tests/torch_port_fixtures.py's K8 edges.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from langsplatv2_tpu.ops import pallas_cascade
from langsplatv2_tpu_torch.ops import cascade
from langsplatv2_tpu_torch.ops.projection import ProjectedGaussians

from torch_port_fixtures import (CASCADE_EDGES, CASCADE_FIELDS,
                                 cascade_budgets, cascade_edge_case)


def _proj(c) -> ProjectedGaussians:
    return ProjectedGaussians(*(torch.from_numpy(c[k])
                                for k in CASCADE_FIELDS))


def _cull(c, g, x, y):
    """JAX's cull of the (Gaussian g, tile (x, y)) pairs, padded to a power
    of two so that few shapes compile."""
    m = g.shape[0]
    if m == 0:
        return np.zeros(0, bool)
    size = 1 << (m - 1).bit_length()
    rows = np.zeros((6, size), np.float32)
    rows[:, :m] = np.concatenate([c["xy"][g].T, c["conic"][g].T,
                                  c["opacities"][g][None]])
    rows[2:5, m:] = 1.0
    tx = np.zeros((1, size), np.int32)
    ty = np.zeros((1, size), np.int32)
    tx[0, :m], ty[0, :m] = x, y
    keep = jax.jit(pallas_cascade._tile_cull_pass)(
        jnp.asarray(rows), jnp.asarray(tx), jnp.asarray(ty))
    return np.asarray(keep)[0, :m]


def _bases(counts, budget: int):
    """JAX's _bases at alignment 1: (bases, counts kept, enabled)."""
    base, cnt, en, _ = pallas_cascade._bases(
        jnp.asarray(counts, jnp.int32), 1, budget)
    return np.asarray(base), np.asarray(cnt), np.asarray(en).astype(bool)


def _expand(ids, lo, hi):
    """(position in ids, child) pairs for children [lo, hi) of each id, in
    id order then child order."""
    h = np.maximum(hi - lo, 0)
    pos = np.repeat(np.arange(ids.shape[0]), h)
    child = lo[pos] + np.arange(pos.shape[0]) - np.repeat(np.cumsum(h) - h,
                                                          h)
    return pos, child


def jax_reference(c, budget: int):
    """(g [budget], start, count, total, overflow) from JAX's order, cull
    and budget rule, and level 0's rows: their total, which are enabled,
    the entries dropped with the disabled ones."""
    gx, gy = c["grid_x"], c["grid_y"]
    n = c["depth"].shape[0]
    bits = lax.bitcast_convert_type(jnp.asarray(c["depth"]), jnp.uint32) \
        & jnp.uint32(0x7FFFFFFF)
    _, order = lax.sort((bits, jnp.arange(n, dtype=jnp.uint32)), num_keys=1,
                        is_stable=True)
    order = np.asarray(order).astype(np.int64)
    ids = order[c["tiles_touched"][order] > 0]
    rmin, rmax = c["rect_min"], c["rect_max"]
    # level 0: stream -> rows, stable by row
    pos, row = _expand(ids, rmin[ids, 1], rmax[ids, 1])
    counts0 = np.bincount(row, minlength=gy)
    _, _, en0 = _bases(counts0, budget)
    perm = np.argsort(row, kind="stable")
    g_rows, y_rows = ids[pos][perm], row[perm]
    keep_row = en0[y_rows]
    g_rows, y_rows = g_rows[keep_row], y_rows[keep_row]
    # level 1: rows -> tiles, culled, stable by tile
    pos, x = _expand(g_rows, rmin[g_rows, 0], rmax[g_rows, 0])
    g, y = g_rows[pos], y_rows[pos]
    keep = _cull(c, g, x, y)
    tile, g = (y * gx + x)[keep], g[keep]
    counts1 = np.bincount(tile, minlength=gx * gy)
    base1, cnt1, en1 = _bases(counts1, budget)
    out = np.zeros(budget, np.int32)
    order1 = np.argsort(tile, kind="stable")
    tile, g = tile[order1], g[order1]
    for t in np.flatnonzero(en1 & (counts1 > 0)):
        out[base1[t]:base1[t] + cnt1[t]] = g[tile == t]
    overflow = (counts0 * ~en0).sum() + (counts1 * ~en1).sum() > 0
    return (out, base1, cnt1, int(cnt1.sum()), bool(overflow)), dict(
        rows_total=int(counts0.sum()), rows_enabled=en0,
        rows_dropped=int((counts0 * ~en0).sum()))


def _check(c, budget: int):
    proj = _proj(c)
    op = torch.from_numpy(c["opacities"])
    plain = cascade.cascade_binning_plain(proj, op, c["grid_x"],
                                          c["grid_y"], budget, 255.0)
    ref, rows = jax_reference(c, budget)
    for name, a, b in zip(("g", "start", "count", "total", "overflow"),
                          plain, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=f"{name} at budget {budget}")
    assert plain[0].dtype == plain[1].dtype == plain[2].dtype == \
        plain[3].dtype == torch.int32 and plain[4].dtype == torch.bool
    return plain, rows


@pytest.mark.parametrize("kind", CASCADE_EDGES)
def test_plain_matches_jax_at_the_budget_edges(kind):
    """Every output of the plain cascade equals JAX's at budgets past the
    total, at it, one below, at a tile's segment end and one below, and for
    the one-level scenes where only that level runs past the budget."""
    c = cascade_edge_case(kind)
    (_, _, count_full, total_full, overflow_full), rows = _check(c, 1 << 16)
    assert not overflow_full
    rows_total = rows["rows_total"]
    flags = {}
    for budget in cascade_budgets(kind, rows_total, count_full.numpy()):
        (g, start, count, total, overflow), rows = _check(c, budget)
        flags[budget] = bool(overflow)
        assert int(total) <= budget
        kept = count > 0
        # what is kept is whole segments of the unbudgeted run, a
        # row-major prefix of its tiles
        assert torch.equal(count[kept], count_full[kept])
        if kept.any():
            assert not bool(kept[int(kept.nonzero().max()) + 1:].any())
        if kind == "level0" and budget == rows_total - 1:
            # only level 0 runs past it: rows are dropped, and level 1
            # keeps every tile of the rows it gets (one-tile-wide rects)
            assert rows["rows_dropped"] > 0 and overflow
            on = torch.from_numpy(np.repeat(rows["rows_enabled"],
                                            c["grid_x"]))
            assert torch.equal(count[on], count_full[on])
            assert int(count[~on].sum()) == 0
        if kind == "level1" and budget == rows_total:
            # only level 1 runs past it: every row is kept
            assert rows["rows_dropped"] == 0 and overflow
    least = max(int(total_full), rows_total)
    assert flags[least] is False
    if kind not in ("dead", "none"):
        assert flags[least - 1] is True
    if kind == "level0":
        assert rows_total - 1 in flags
    if kind == "level1":
        assert rows_total < int(total_full) and rows_total in flags


def test_wide_rects_cull_past_64_tiles():
    """Rects of 65-90 tiles: the cull drops tiles past the 64th of some
    rects and keeps them in others, in JAX and in the plain version."""
    c = cascade_edge_case("wide")
    _check(c, 1 << 16)
    ids = np.flatnonzero(c["tiles_touched"] > 0)
    pos, x = _expand(ids, c["rect_min"][ids, 0], c["rect_max"][ids, 0])
    g = ids[pos]
    far = x - c["rect_min"][g, 0] >= 64
    keep = _cull(c, g, x, c["rect_min"][g, 1])
    assert keep[far].any() and not keep[far].all()


@pytest.mark.parametrize("kind", ["level0", "level1", "chunks", "widest"])
def test_workspace_plan_bounds_the_live_chunks(kind):
    """The CUDA path's plan: level 1's grid (chunks1) is at least the live
    chunks, counted from the plain version's enabled rows, at every budget
    edge; the buffers hold what each pass writes; the keep bits sit at an
    8-byte-aligned offset."""
    c = cascade_edge_case(kind)
    gx, gy, n = c["grid_x"], c["grid_y"], c["depth"].shape[0]
    rmin, rmax, alive = c["rect_min"], c["rect_max"], c["tiles_touched"] > 0
    rows = np.zeros(gy, np.int64)
    for g in np.flatnonzero(alive):
        rows[rmin[g, 1]:rmax[g, 1]] += 1
    ends = np.cumsum(rows)
    for budget in sorted({int(e) for e in ends} | {0, 1, int(ends[-1]) - 1}):
        budget = max(budget, 0)
        plan = cascade.workspace_plan(n, gx, gy, budget)
        enabled = rows * (ends <= budget)
        live = int(np.sum(-(-enabled // cascade.CHUNK)))
        assert live <= plan["chunks1"]
        off = plan["offsets"]
        assert off["gauss"] == 0 and off["mask1"] % 2 == 0
        assert off["rows"] - off["mask1"] >= 2 * budget
        assert plan["chunks0"] == -(-n // cascade.CHUNK)
        assert off["counts1"] + plan["chunks1"] * gx == plan["words"]
        assert plan["zbuf"] == gy + 4 + gx * gy


def test_cuda_path_refuses_what_the_kernels_do_not_take():
    """Past MAX_FAN tiles a side the cascade raises on every device; on the
    card a budget past MAX_BUDGET raises too (the look-back's 30-bit
    words): checked here through the plan's constants."""
    c = cascade_edge_case("column")
    proj, op = _proj(c), torch.from_numpy(c["opacities"])
    with pytest.raises(ValueError, match="tiles a side"):
        cascade.cascade_binning(proj, op, cascade.MAX_FAN + 1, 2, 64)
    assert cascade.MAX_BUDGET == (1 << 30) - 1
    assert cascade.LAUNCHES == 6
