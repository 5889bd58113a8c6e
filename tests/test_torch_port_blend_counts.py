"""K2's pair counts: `ops/blend.py::pair_counts_plain` against a scalar
per-pixel loop.

The kernel's `stats` count the (entry, pixel) pairs each pixel evaluates,
up to and including the entry that ends it, and the pairs it includes;
the card checks hold the kernel's counts equal to `pair_counts_plain`'s.
Here `pair_counts_plain` (the vectorized replay) is held against a loop
that walks each pixel's segment one entry at a time in numpy f32 scalars.
Its transcendental values come from torch's own exp and log1p, evaluated
once over all inputs (for the bf16 cells over all bf16 values), so that a
boundary compare cannot flip on an ulp of another libm.
"""
import numpy as np
import pytest
import torch

from langsplatv2_tpu_torch.ops import blend

GX, GY = 3, 2
COUNTS = [0, 7, 60, 23, 150, 41]      # tile 0 empty


def _scene(seed: int = 0):
    """Gaussians over a 48x32 image: wide and opaque enough that most
    pixels end mid-segment; every 11th has a NaN x, every 13th an
    indefinite conic (power > 0 off its axis), a few lie far outside."""
    rng = np.random.default_rng(seed)
    n = 400
    xy = np.stack([rng.uniform(-4, 52, n), rng.uniform(-4, 36, n)], 1)
    s = rng.uniform(4.0, 14.0, (n, 2))
    geom = np.zeros((n, 9), np.float32)
    geom[:, 0:2] = xy
    geom[:, 2] = 1 / s[:, 0] ** 2
    geom[:, 3] = rng.uniform(-0.3, 0.3, n) / (s[:, 0] * s[:, 1])
    geom[:, 4] = 1 / s[:, 1] ** 2
    geom[:, 5] = rng.uniform(0.2, 0.99, n)
    geom[:, 6:9] = rng.uniform(0, 1, (n, 3))
    geom[::11, 0] = np.nan
    geom[::13, 2] = -geom[::13, 2]
    geom[5::17, 0:2] = [400.0, -300.0]
    ids = [rng.integers(0, n, c) for c in COUNTS]
    g = np.concatenate(ids).astype(np.int32)
    count = np.array(COUNTS, np.int32)
    start = (np.cumsum(count) - count).astype(np.int32)
    return torch.from_numpy(g), torch.from_numpy(start), \
        torch.from_numpy(count), torch.from_numpy(geom)


def _bf16(x: np.float32) -> np.float32:
    """Round an f32 to bf16, to nearest even (finite inputs)."""
    b = np.array(x, np.float32).view(np.uint32)
    b = (b + np.uint32(0x7FFF) + ((b >> np.uint32(16)) & np.uint32(1))) \
        & np.uint32(0xFFFF0000)
    return b.view(np.float32)[()]


def _bf16_table(fn):
    """fn over every bf16 value (torch, one vectorized call), indexed by
    the value's upper 16 bits."""
    allv = torch.arange(1 << 16, dtype=torch.int32).to(torch.int16) \
        .view(torch.bfloat16)
    return fn(allv).float().numpy()


def _bits(x: np.float32) -> int:
    return int(np.array(x, np.float32).view(np.uint32)) >> 16


def _scalar_counts(g, start, count, geom, cells: bool):
    """(evaluated, included, termination positions, power > 0 pairs,
    alpha < 1/255 pairs) by a per-pixel loop."""
    g, start, count = g.numpy(), start.numpy(), count.numpy()
    geom = geom.numpy()
    f32 = np.float32
    # exp(power) for every (tile, position, pixel) pair, one torch call.
    pix = np.arange(256)
    powers = {}
    for t in range(GX * GY):
        px = ((t % GX) * 16 + pix % 16).astype(f32)
        py = ((t // GX) * 16 + pix // 16).astype(f32)
        rows = geom[g[start[t]:start[t] + count[t]]]
        dx = px[None, :] - rows[:, 0:1]
        dy = py[None, :] - rows[:, 1:2]
        ca, cb, cc = rows[:, 2:3], rows[:, 3:4], rows[:, 4:5]
        powers[t] = f32(-0.5) * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    flat = np.concatenate([p.ravel() for p in powers.values()])
    pad = np.zeros(-len(flat) % 64, f32)
    exp_all = torch.exp(torch.from_numpy(np.concatenate([flat, pad]))) \
        .numpy()[:len(flat)]
    exp_b = _bf16_table(torch.exp)
    log1p_neg_b = _bf16_table(lambda v: torch.log1p(-v.float()))
    n_eval = n_inc = n_pos = n_faint = 0
    ends = []
    off = 0
    for t in range(GX * GY):
        p = powers[t]
        e = exp_all[off:off + p.size].reshape(p.shape)
        off += p.size
        for q in range(256):
            T, S = f32(1.0), f32(0.0)
            for j in range(count[t]):
                n_eval += 1
                power = p[j, q]
                if not power <= 0.0:
                    n_pos += 1
                    continue
                op = geom[g[start[t] + j], 5]
                if cells:
                    eb = _bf16(exp_b[_bits(_bf16(power))])
                    ab = min(_bf16(_bf16(op) * eb), _bf16(f32(0.99)))
                    tb = _bf16(exp_b[_bits(_bf16(S))])
                    alpha = ab
                    test_t = _bf16(tb * _bf16(f32(1.0) - ab))
                else:
                    alpha = min(f32(op * e[j, q]), f32(0.99))
                    test_t = f32(T * (f32(1.0) - alpha))
                if alpha < f32(1.0 / 255.0):
                    n_faint += 1
                    continue
                if test_t < f32(1e-4):
                    ends.append(j)
                    break
                n_inc += 1
                if cells:
                    S = f32(S + _bf16(log1p_neg_b[_bits(alpha)]))
                else:
                    T = test_t
    return n_eval, n_inc, ends, n_pos, n_faint


@pytest.mark.parametrize("cells", [False, True], ids=["f32", "bf16_cells"])
def test_pair_counts_match_scalar_loop(cells):
    g, start, count, geom = _scene()
    n_eval, n_inc, ends, n_pos, n_faint = _scalar_counts(g, start, count,
                                                         geom, cells)
    # The scene has what the counts must get right: terminations inside a
    # batch and on its last entry's neighbours, skipped pairs of both
    # kinds, and an empty tile.
    assert len(ends) > 200 and len(set(ends)) > 10
    assert any(j % blend.BATCH not in (0, blend.BATCH - 1) for j in ends)
    assert n_pos > 0 and n_faint > 0 and COUNTS[0] == 0
    assert 0 < n_inc < n_eval
    assert blend.pair_counts_plain(g, start, count, geom, GX,
                                   cells_bf16=cells) == (n_eval, n_inc)


def test_pair_counts_leave_the_replay_unchanged():
    """Counting `evaluated` does not change what the replay yields, and the
    included count is the number of nonzero blend weights of the plain
    blend's pass."""
    g, start, count, geom = _scene(1)
    evaluated = torch.zeros((GX * GY, 256), dtype=torch.int64)
    a = list(blend.replay_positions(g, start, count, geom, GX))
    b = list(blend.replay_positions(g, start, count, geom, GX,
                                    evaluated=evaluated))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for u, v in zip(x[1:], y[1:]):
            torch.testing.assert_close(u, v, rtol=0, atol=0, equal_nan=True)
    n_eval, n_inc = blend.pair_counts_plain(g, start, count, geom, GX)
    assert n_eval == int(evaluated.sum())
    assert n_inc == sum(int((x[4] > 0).sum()) for x in a)
    assert int(evaluated[0].sum()) == 0          # the empty tile
    assert bool((evaluated[1:] <= count[1:, None]).all())
