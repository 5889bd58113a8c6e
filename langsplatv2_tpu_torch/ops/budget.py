"""Budget-capped binning: dense per-tile windows and the transmittance
budget (port of langsplatv2_tpu/ops/pallas_binning.py::slice_windows :663,
::budget_from_rows :673-743, and the round-4 chain's LM_QSTEP,
pack_lm_words / unpack_lm_words :637-660, budget_counts_windowed :746-778
and budget_counts :781-832).

The JAX package runs all of them in XLA, not in Pallas, so they are plain
PyTorch here. Each tile t gets the window of `cap` sorted entries from its
segment start, and keeps the depth prefix of entries whose transmittance
bound, the product of (1 - alpha_max) over the entries before it in some
sub-box of the tile, stays at or above the budget. The kept counts are
integer entry sets: the op order is JAX's, so that they agree exactly.

Two routes give the bound. `budget_from_rows` (the capped routes of
ops/rasterize.py) recomputes it from the window slots' state in f32. The
round-4 chain takes it from the expansion (ops/expand.py, with_alpha),
quantizes it to u8 quanta of LM_QSTEP rounded toward 0 (which only keeps
more entries), packs four sub-boxes into a sort-payload word, and sums
integer quanta: exact, deterministic cutoffs. Words are int32 tensors
holding JAX's u32 bit patterns.
"""
from __future__ import annotations

import numpy as np
import torch

from .projection import BLOCK


def slice_windows(arr, tile_start, cap: int):
    """[E] sorted array -> [T, cap] windows starting at tile_start. The
    array is padded by `cap` zeros (for g_sorted a valid Gaussian id, as in
    JAX) so that no window is cut short at its end."""
    a_pad = torch.cat([arr, arr.new_zeros(cap)])
    idx = tile_start.long()[:, None] + torch.arange(cap, device=arr.device)
    return a_pad[idx]


def budget_from_rows(xy, conic, op, tile_count, grid_x: int, cap: int,
                     subdiv: int, t_budget: float):
    """Per-tile budget counts from the window slots' state: xy [T*cap, 2],
    conic [T*cap, 3], op [T*cap] (slot e of tile t at t*cap + e), and the
    tiles' raw entry counts tile_count [T]. Returns (kept [T] i32, the
    blend counts, kept <= min(count, cap); sat_bound [T] i32, the tile's
    full count where the budget prefix filled the window of a tile with
    more than `cap` entries, else kept)."""
    dev = xy.device
    t_total = tile_count.shape[0]
    slot_tile = torch.arange(t_total * cap, dtype=torch.int32,
                             device=dev) // cap
    # All sub-boxes at once, [T*cap, Q]: the same elementwise ops as JAX's
    # loop over them, in one launch each.
    tx = (slot_tile % grid_x).float()[:, None]
    ty = (slot_tile // grid_x).float()[:, None]
    cx, cy = xy[:, 0:1], xy[:, 1:2]
    ca = torch.clamp(conic[:, 0:1], min=1e-12)
    cb = conic[:, 1:2]
    cc = torch.clamp(conic[:, 2:3], min=1e-12)

    def q(u, v):
        return ca * u * u + 2.0 * cb * u * v + cc * v * v

    def box_qmin(lx, hx, ly, hy):
        edge_u = [q(u, torch.minimum(torch.maximum(-cb * u / cc, ly), hy))
                  for u in (lx, hx)]
        edge_v = [q(torch.minimum(torch.maximum(-cb * v / ca, lx), hx), v)
                  for v in (ly, hy)]
        inside = (lx <= 0.0) & (0.0 <= hx) & (ly <= 0.0) & (0.0 <= hy)
        q_min = torch.minimum(torch.minimum(*edge_u), torch.minimum(*edge_v))
        return torch.where(inside, 0.0, q_min)

    side = BLOCK // subdiv
    sy, sx = np.divmod(np.arange(subdiv * subdiv), subdiv)
    off_x = torch.tensor(sx * side, dtype=torch.float32, device=dev)
    off_y = torch.tensor(sy * side, dtype=torch.float32, device=dev)
    op_c = torch.clamp(op, max=1.0)[:, None]
    lx = tx * float(BLOCK) + off_x - cx
    ly = ty * float(BLOCK) + off_y - cy
    qm = box_qmin(lx, lx + float(side - 1), ly, ly + float(side - 1))
    am = torch.clamp(op_c * torch.exp(-0.5 * torch.clamp(qm, min=0.0)),
                     max=0.99)
    lm = torch.log1p(-am).reshape(t_total, cap, -1)             # [T, cap, Q]
    incap = torch.clamp(tile_count, max=cap)
    inwin = torch.arange(cap, device=dev)[None, :] < incap[:, None]
    lm = torch.where(inwin[..., None], lm, 0.0)
    s_excl = torch.cumsum(lm, dim=1) - lm                       # exclusive
    logb = float(np.float32(np.log(t_budget)))
    ok = (s_excl >= logb).any(dim=-1) & inwin
    kept = ok.sum(dim=1, dtype=torch.int32)
    sat_bound = torch.where((kept >= incap) & (tile_count > cap), tile_count,
                            kept).int()
    return kept, sat_bound


# u8 quantization step of the lm payload: lm lies in [log1p(-0.99), 0] ~
# [-4.7, 0] by the alpha clamp.
LM_QSTEP = 4.7 / 255.0
# JAX multiplies by Python floats, cast to f32: keep those constants.
_INV_QSTEP = float(np.float32(1.0 / LM_QSTEP))
_NEG_INV_QSTEP = float(np.float32(-1.0 / LM_QSTEP))
_QSTEP = float(np.float32(LM_QSTEP))


def pack_lm_words(lms):
    """lm arrays ([E] f32, <= 0; a sequence, or [Q, E] rows) -> u8 quanta
    rounded toward 0, four to a word: a tuple of ceil(Q / 4) [E] int32
    words (the u32 bit patterns)."""
    words = []
    for i in range(0, len(lms), 4):
        wrd = torch.zeros(lms[0].shape, dtype=torch.int64,
                          device=lms[0].device)
        for k, lm in enumerate(lms[i:i + 4]):
            n = torch.clamp(torch.floor(-lm * _INV_QSTEP), max=255.0)
            wrd = wrd | (n.long() << (8 * k))
        words.append(wrd.to(torch.int32))
    return tuple(words)


def unpack_lm_words(words, n_box: int):
    """Inverse of pack_lm_words: [E] int32 words -> [E, n_box] f32 lm."""
    lms = []
    for i, wrd in enumerate(words):
        wrd = wrd.long() & 0xFFFFFFFF
        for k in range(min(4, n_box - 4 * i)):
            n = ((wrd >> (8 * k)) & 0xFF).float()
            lms.append(-n * _QSTEP)
    return torch.stack(lms, dim=1)


def _qbudget(t_budget: float) -> int:
    """Keep while sum(lm) >= log(budget) <=> sum(quanta) <= qbudget."""
    return int(np.int32(np.floor(-np.log(t_budget) / LM_QSTEP)))


def budget_counts_windowed(words_win, tile_count, cap: int, n_box: int,
                           t_budget: float):
    """Per-tile kept counts from lm words already in the [T, cap] window
    layout (slice_windows of the sorted pack_lm_words words): the
    integer-quanta test of `budget_counts` inside the window. Returns
    (kept [T] i32 <= min(count, cap), the blend counts; sat_bound [T] i32,
    the tile's full count where the kept prefix filled the window of a
    tile with more than `cap` entries, else kept)."""
    lm = unpack_lm_words(tuple(w.reshape(-1) for w in words_win), n_box)
    t = words_win[0].shape[0]
    q = torch.round(lm.reshape(t, cap, n_box) * _NEG_INV_QSTEP).int()
    assert cap * 255 < 2 ** 31
    s_excl = torch.cumsum(q, dim=1, dtype=torch.int32) - q     # exclusive
    incap = torch.clamp(tile_count, max=cap)
    slot = torch.arange(cap, device=q.device)
    ok = ((s_excl <= _qbudget(t_budget)).any(dim=-1)
          & (slot[None, :] < incap[:, None]))
    kept = ok.sum(dim=1, dtype=torch.int32)
    sat_bound = torch.where((kept >= incap) & (tile_count > cap),
                            tile_count, kept).int()
    return kept, sat_bound


def budget_counts(lm_sorted, tile_start, tile_count, t_budget: float):
    """Per-tile kept counts under the transmittance budget, over whole
    segments: lm_sorted [E] or [E, Q] f32 (u8-quantized lm, sorted). Entry
    j of tile t is kept iff some sub-box's exclusive sum of quanta before
    it is <= qbudget; entry 0 of a non-empty tile always is. An int32
    cumsum of the quanta over all entries, then JAX's per-tile binary
    search, step for step (the predicate is monotone in a segment).
    Returns kept [T] i32 <= tile_count."""
    if lm_sorted.dim() == 1:
        lm_sorted = lm_sorted[:, None]
    e = lm_sorted.shape[0]
    assert e * 255 < 2 ** 31, "int32 quanta cumsum overflows above ~8.4M"
    q = torch.round(lm_sorted * _NEG_INV_QSTEP).int()
    s = torch.cumsum(q, dim=0, dtype=torch.int32)              # inclusive
    start = tile_start.long()
    base = torch.where((start > 0)[:, None], s[torch.clamp(start - 1, min=0)],
                       0)
    target = base + _qbudget(t_budget)
    lo = start
    hi = start + torch.clamp(tile_count.long() - 1, min=0)
    for _ in range(max(1, int(np.ceil(np.log2(e + 1))) + 1)):
        mid = (lo + hi) // 2
        go_right = (s[torch.clamp(mid, max=e - 1)] <= target).any(dim=1)
        lo, hi = (torch.where(go_right, mid + 1, lo),
                  torch.where(go_right, hi, mid))
    kept = lo - start + 1
    return torch.where(tile_count > 0, torch.minimum(kept, tile_count.long()),
                       0).int()
