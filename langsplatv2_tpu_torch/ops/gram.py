"""Fused Gram-space cosine loss of feature training, kernels K6a (forward)
and K6b (backward) (port of langsplatv2_tpu/ops/pallas_gram.py).

    loss = 1 - sum_p sim_p / (H*W),
    sim_p = (w_p . phi[seg_p]) / (max(|feat_p|, eps) * max(|gt_p|, eps)),
    |feat_p|^2 = w_p^T G w_p,

on the tile-layout weight map [T, 256, L*K], in K-dim space: phi [S, M]
(the GT segment table folded into the codebooks of layers 0..lay,
M = (lay+1)*K) and G [M, M] (the codebooks' block Gram matrix) come from
`prep`, a pair of plain products outside the kernels, as in the JAX module.
Layers below `lay` enter by value only (the curriculum's stop-gradient);
the map's gradient is non-zero only in layer `lay`'s K columns and the
codebooks' only in codebook `lay`.

`gram_tiles_fwd` / `gram_tiles_bwd` launch csrc/gram.cu on CUDA tensors and
run `gram_tiles_fwd_plain` / `gram_tiles_bwd_plain` (the same per-pixel
chain in torch ops) on CPU tensors. `gram_loss_fused` wires them into a
torch.autograd.Function; `train/trainer.py::gram_cos_loss_tiles` is the
differentiable XLA formulation it is held against. The kernels are bound by
the bytes of the weight map (and of its gradient); csrc/gram.cu says how
their design meets that. They take every M and K the Pallas kernels take:
`kernel_plan` (a pure function of the shapes) gives the instantiation and
the launches, each launch's widths a `Pass`.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import kernels
from .projection import BLOCK

P = BLOCK * BLOCK
PANEL = 64          # csrc/gram.cu kPanel: G's split blocks are PANEL^2
STAGE_PANELS = 4    # kMaxStagePanels: the widest shared stage (256 columns)
ROW_BLOCK = 128     # kRowBlock: d_G rows an unstaged launch accumulates


class Pass(NamedTuple):
    """One launch's widths (csrc/gram.cu `Pass`): G [M, M], the layer width
    K (0 for K6a), the contraction's k-panels n_k and the output column
    panels n_out; the output columns before layer lay's block, no, padded
    to po; the block's map columns [c0, c0 + kb) (kb <= 64) and its first
    column j0 in d_phi and d_G; the first d_G row r0; whether the launch
    writes d_w and d_phi (dw) and d_w's zeros outside the block
    (zero_rest)."""
    M: int
    K: int
    n_k: int
    n_out: int
    no: int
    po: int
    c0: int
    kb: int
    j0: int
    r0: int
    dw: int
    zero_rest: int


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def kernel_plan(M: int, K: int | None = None, C: int | None = None) -> dict:
    """The launches of K6a (K None) or K6b (layer width K, M = (lay+1)*K) on
    G [M, M] and a map of C columns (default M): `kpk`, the stage's
    64-column k-panels (0: unstaged, M > 256), `any` (the run-time-width
    instantiation, unless K6a's M or K6b's K = 64 and M is 64, 128, 192 or
    256 on a C that is a multiple of 4), the `passes` in launch order and
    `gsplit_floats`, the scratch of G's split fragments. Output columns
    are the map columns outside layer lay's block in order, padded to a
    whole panel, then the block (K6a: the M columns); K6b's layer goes in
    blocks of at most 64 columns, one pass each, and unstaged in row blocks
    of ROW_BLOCK d_G rows."""
    C = M if C is None else C
    if not 0 < M <= C:
        raise ValueError(f"G [{M}, {M}] on a map of {C} columns")
    n_k = _ceil(M, PANEL)
    staged = n_k <= STAGE_PANELS
    kpk = n_k if staged else 0
    if K is None:
        fast = staged and M == PANEL * n_k and C % 4 == 0
        passes = [Pass(M, 0, n_k, n_k, M, PANEL * n_k, M, 0, 0, 0, 0, 0)]
    else:
        if K < 1 or M % K:
            raise ValueError(f"G [{M}, {M}] is not whole layers of K={K}")
        lo = M - K
        fast = K == PANEL and M % PANEL == 0 and staged and C % 4 == 0
        passes = []
        for jb in range(_ceil(K, PANEL)):
            kb = min(PANEL, K - PANEL * jb)
            no = M - kb
            po = _ceil(no, PANEL) * PANEL
            for rb in range(1 if staged else _ceil(M, ROW_BLOCK)):
                passes.append(Pass(M, K, n_k, po // PANEL + 1, no, po,
                                   lo + PANEL * jb, kb, PANEL * jb,
                                   ROW_BLOCK * rb, int(rb == 0),
                                   int(rb == 0 and jb == 0)))
        if kpk == 1 and any(p.n_out > 1 for p in passes):
            kpk = 2       # G resident in shared memory only as one block
    return dict(kpk=kpk, any=not fast, passes=passes,
                gsplit_floats=max(2 * PANEL * PANEL * p.n_out * p.n_k
                                  for p in passes))


def out_columns(p: Pass) -> list[int]:
    """The map column of each output column of a pass (-1: padding), as
    csrc/gram.cu::out_col."""
    cols = []
    for n in range(PANEL * p.n_out):
        if n < p.po:
            cols.append((n if n < p.c0 else n + p.kb) if n < p.no else -1)
        else:
            cols.append(p.c0 + n - p.po if n - p.po < p.kb else -1)
    return cols


def prep(codebooks, gt_table, lay: int):
    """rhs [S, M+1] (phi columns of layers 0..lay, then the GT norms) and
    G [M, M], as values (the backward assembles the codebook gradient)."""
    cbs = codebooks[:lay + 1].detach()
    table = gt_table.detach()
    phis = [table @ c.T for c in cbs]                        # [S, K] each
    gt_n = torch.linalg.norm(table, dim=1, keepdim=True)
    rhs = torch.cat(phis + [gt_n], dim=1).contiguous()
    call = cbs.reshape(-1, cbs.shape[2])                     # [M, D]
    return rhs, (call @ call.T).contiguous()


def seg_to_tiles(seg_map, grid_x: int, grid_y: int):
    """[H, W] segment ids -> [T, 256] int32 in tile-pixel order, -1 on the
    padding beyond the image."""
    H, W = seg_map.shape
    seg = torch.full((grid_y * BLOCK, grid_x * BLOCK), -1, dtype=torch.int32,
                     device=seg_map.device)
    seg[:H, :W] = seg_map
    return seg.reshape(grid_y, BLOCK, grid_x, BLOCK).permute(
        0, 2, 1, 3).reshape(grid_x * grid_y, P).contiguous()


def _chain(w, seg, rhs, gfull, eps):
    """The per-pixel chain of pallas_gram._chain on w [T, 256, M]."""
    m = gfull.shape[0]
    valid = seg >= 0
    looked = torch.where(valid[..., None], rhs[seg.clamp(min=0).long()],
                         0.0)                                # [T, 256, M+1]
    phi, gtnp = looked[..., :m], looked[..., m]
    num = (w * phi).sum(-1)
    wg = w @ gfull
    n2 = (w * wg).sum(-1)
    covered = n2 > 0.0
    n2g = torch.where(covered, n2, 1.0)
    nrm = torch.where(covered, torch.sqrt(n2g), 0.0)
    a = torch.clamp(nrm, min=eps)
    b = torch.clamp(gtnp, min=eps)
    return dict(valid=valid, phi=phi, num=num, wg=wg, covered=covered,
                n2g=n2g, nrm=nrm, a=a, b=b)


def gram_tiles_fwd_plain(seg_tiles, wmap_tiles, rhs, gfull, eps: float):
    c = _chain(wmap_tiles[..., :gfull.shape[0]], seg_tiles, rhs, gfull, eps)
    return (c["num"] / (c["a"] * c["b"])).sum(-1)


def _launch(bwd: bool, plan: dict, seg_tiles, wmap_tiles, rhs, gfull,
            eps: float, inv_hw: float, upstream, out, dphi, dg):
    """Every pass of `plan` (one csrc/gram.cu launch each), in order."""
    t, _, c = wmap_tiles.shape
    gsplit = torch.empty(plan["gsplit_floats"], device=wmap_tiles.device)
    ptr, null = kernels.ptr, kernels.NULL
    for p in plan["passes"]:
        widths = (ctypes.c_int * len(p))(*p)
        kernels.launch(
            "lsv2_gram", int(bwd), plan["kpk"], int(plan["any"]),
            ptr(seg_tiles), ptr(wmap_tiles), ptr(rhs), ptr(gfull), t, c,
            ctypes.cast(widths, ctypes.c_void_p), eps, inv_hw,
            ptr(upstream) if bwd else null, ptr(out),
            ptr(dphi) if bwd else null, ptr(dg) if bwd else null,
            ptr(gsplit), kernels.stream(out))


def gram_tiles_fwd(seg_tiles, wmap_tiles, rhs, gfull, eps: float = 1e-8):
    """Per-tile sums of sim [T] for seg_tiles [T, 256] i32, wmap_tiles
    [T, 256, C] f32 (its first M columns used), rhs [S, M+1], G [M, M]."""
    dev = wmap_tiles.device
    if dev.type == "cpu":
        return gram_tiles_fwd_plain(seg_tiles, wmap_tiles, rhs, gfull, eps)
    t, c, m = _check(seg_tiles, wmap_tiles, rhs, gfull)
    partial = torch.zeros(t, device=dev)
    _launch(False, kernel_plan(m, None, c), seg_tiles, _aligned(wmap_tiles),
            rhs, gfull, eps, 0.0, None, partial, None, None)
    gram_tiles_fwd.launches += 1
    return partial


gram_tiles_fwd.launches = 0


def gram_tiles_bwd_plain(seg_tiles, wmap_tiles, rhs, gfull, lay: int,
                         k: int, eps: float, inv_hw: float, upstream):
    m = gfull.shape[0]
    w = wmap_tiles[..., :m]
    c = _chain(w, seg_tiles, rhs, gfull, eps)
    d_sim = -inv_hw * upstream
    inv_ab = 1.0 / (c["a"] * c["b"])
    d_num = d_sim * inv_ab
    d_a = -d_sim * c["num"] * inv_ab / c["a"]
    dmax = torch.where(c["nrm"] > eps, 1.0,
                       torch.where(c["nrm"] == eps, 0.5, 0.0))
    d_n2 = torch.where(c["covered"], d_a * dmax * 0.5 / torch.sqrt(c["n2g"]),
                       0.0)
    lo = lay * k
    dw = torch.zeros_like(wmap_tiles)
    dw[..., lo:lo + k] = (d_num[..., None] * c["phi"][..., lo:lo + k]
                          + 2.0 * d_n2[..., None] * c["wg"][..., lo:lo + k])
    w_l = w[..., lo:lo + k].reshape(-1, k)
    valid = c["valid"].reshape(-1)
    dphi = torch.zeros((rhs.shape[0], k), device=w.device).index_add_(
        0, seg_tiles.reshape(-1)[valid].long(),
        (d_num.reshape(-1, 1) * w_l)[valid])
    dg = w.reshape(-1, m).T @ (d_n2.reshape(-1, 1) * w_l)
    return dw, dphi, dg


def gram_tiles_bwd(seg_tiles, wmap_tiles, rhs, gfull, lay: int, k: int,
                   eps: float, inv_hw: float, upstream):
    """(d_wmap [T, 256, C], d_phi [S, K], d_G [M, K]) of the sum of sims
    scaled by -inv_hw * upstream (a 0-d tensor: the loss's cotangent);
    d_wmap is zero outside layer `lay`'s columns."""
    dev = wmap_tiles.device
    if dev.type == "cpu":
        return gram_tiles_bwd_plain(seg_tiles, wmap_tiles, rhs, gfull, lay,
                                    k, eps, inv_hw, upstream)
    t, c, m = _check(seg_tiles, wmap_tiles, rhs, gfull)
    if (lay + 1) * k != m:
        raise ValueError(f"layer {lay} of K={k} does not match G [{m}, {m}]")
    upstream = upstream.reshape(1).to(torch.float32).contiguous()
    dw = torch.empty_like(wmap_tiles)
    dphi = torch.zeros((rhs.shape[0], k), device=dev)
    dg = torch.zeros((m, k), device=dev)
    _launch(True, kernel_plan(m, k, c), seg_tiles, _aligned(wmap_tiles), rhs,
            gfull, eps, inv_hw, upstream, dw, dphi, dg)
    gram_tiles_bwd.launches += 1
    return dw, dphi, dg


gram_tiles_bwd.launches = 0


def occupancy(bwd: bool, m: int, k: int | None = None, c: int | None = None
              ) -> dict:
    """The instantiation `kernel_plan` picks for K6a (bwd False) or K6b at
    G [m, m] (CUDA only): resident blocks and warps an SM, dynamic shared
    bytes, registers and local (spill, stack) bytes a thread, from the CUDA
    runtime."""
    plan = kernel_plan(m, k if bwd else None, c)
    return kernels.occupancy("lsv2_gram_occupancy", int(bwd), plan["kpk"],
                             int(plan["any"]))


def _aligned(t):
    """t, or a copy of it where its data is not 16-byte aligned (the
    kernels' 16-byte copies)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check(seg_tiles, wmap_tiles, rhs, gfull):
    dev = wmap_tiles.device
    if dev.type != "cuda":
        raise ValueError(f"gram kernels: unsupported device {dev}")
    t, _, c = wmap_tiles.shape
    m = gfull.shape[0]
    if not 0 < m <= c:
        raise ValueError(f"G [{m}, {m}]: M must be at most the map's {c} "
                         f"channels")
    kernels.check_tensor(seg_tiles, "seg_tiles", torch.int32, (t, P), dev)
    kernels.check_tensor(wmap_tiles, "wmap_tiles", torch.float32, (t, P, c),
                         dev)
    kernels.check_tensor(rhs, "rhs", torch.float32, (None, m + 1), dev)
    kernels.check_tensor(gfull, "gfull", torch.float32, (m, m), dev)
    return t, c, m


class GramLossFused(torch.autograd.Function):
    """1 - sum(sim) / hw with gradients to codebooks [L, K, D] and the map
    [T, 256, L*K]; the GT table and segment ids get none."""

    @staticmethod
    def forward(ctx, codebooks, wmap_tiles, gt_table, seg_tiles, lay, hw,
                eps):
        rhs, gfull = prep(codebooks, gt_table, lay)
        total = gram_tiles_fwd(seg_tiles, wmap_tiles.contiguous(), rhs,
                               gfull, eps).sum()
        ctx.save_for_backward(codebooks, wmap_tiles, gt_table, seg_tiles,
                              rhs, gfull)
        ctx.args = (lay, hw, eps)
        return 1.0 - total / hw

    @staticmethod
    def backward(ctx, g):
        codebooks, wmap_tiles, gt_table, seg_tiles, rhs, gfull = \
            ctx.saved_tensors
        lay, hw, eps = ctx.args
        K = codebooks.shape[1]
        dw, dphi, dg = gram_tiles_bwd(seg_tiles, wmap_tiles.contiguous(),
                                      rhs, gfull, lay, K, eps, 1.0 / hw, g)
        # phi path: phi_lay = table @ C_lay^T -> d C_lay += d_phi^T @ table;
        # Gram path: G_jl = C_j C_l^T, d_G symmetric -> d C_lay +=
        # 2 sum_j d_G_jl^T @ C_j, with d_G_jl stacked in dg.
        d_cl = dphi.T @ gt_table.detach() + 2.0 * torch.einsum(
            "jab,jad->bd", dg.reshape(lay + 1, K, K),
            codebooks[:lay + 1].detach())
        d_codebooks = torch.zeros_like(codebooks)
        d_codebooks[lay] = d_cl
        return d_codebooks, dw, None, None, None, None, None


def gram_loss_fused(codebooks, wmap_tiles, gt_table, seg_map, layer_idx: int,
                    grid_x: int | None = None, grid_y: int | None = None,
                    eps: float = 1e-8):
    """The JAX `gram_loss_fused`: the loss on tile-layout weight maps
    [T, 256, L*K] against the GT table [S, 512] and segment map [H, W]
    (-1 = masked); the mean divides by H*W."""
    H, W = seg_map.shape
    grid_x = -(-W // BLOCK) if grid_x is None else grid_x
    grid_y = -(-H // BLOCK) if grid_y is None else grid_y
    if wmap_tiles.shape[0] != grid_x * grid_y:
        raise ValueError(f"{wmap_tiles.shape[0]} map tiles, grid "
                         f"{grid_x}x{grid_y}")
    seg_tiles = seg_to_tiles(seg_map, grid_x, grid_y)
    return GramLossFused.apply(codebooks, wmap_tiles, gt_table, seg_tiles,
                               int(layer_idx), H * W, eps)
