"""Budget-capped binning: dense per-tile windows and the transmittance
budget (port of langsplatv2_tpu/ops/pallas_binning.py::slice_windows :663
and ::budget_from_rows :673-743).

The JAX package runs both in XLA, not in Pallas, so they are plain
PyTorch here. Each tile t gets the window of `cap` sorted entries from its
segment start, and keeps the depth prefix of entries whose transmittance
bound, the product of (1 - alpha_max) over the entries before it in some
sub-box of the tile, stays at or above the budget. The kept counts are
integer entry sets: the op order is JAX's, so that they agree exactly.
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
