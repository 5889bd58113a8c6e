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
their design meets that.
"""
from __future__ import annotations

import torch

from . import kernels
from .projection import BLOCK

P = BLOCK * BLOCK
BWD_K = 64                  # codebook rows a layer the backward kernel takes
BWD_M = (64, 128, 192)      # its widths of G (layers 0..lay)


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


def gram_tiles_fwd(seg_tiles, wmap_tiles, rhs, gfull, eps: float = 1e-8):
    """Per-tile sums of sim [T] for seg_tiles [T, 256] i32, wmap_tiles
    [T, 256, C] f32 (its first M columns used), rhs [S, M+1], G [M, M]."""
    dev = wmap_tiles.device
    if dev.type == "cpu":
        return gram_tiles_fwd_plain(seg_tiles, wmap_tiles, rhs, gfull, eps)
    t, c, m = _check(seg_tiles, wmap_tiles, rhs, gfull)
    partial = torch.empty(t, device=dev)
    ptr = kernels.ptr
    kernels.launch("lsv2_gram_fwd", ptr(seg_tiles), ptr(wmap_tiles),
                   ptr(rhs), ptr(gfull), t, c, m, eps, ptr(partial),
                   kernels.stream(partial))
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
    if k != BWD_K or m not in BWD_M or c % 4:
        raise NotImplementedError(
            f"the gram backward kernel takes K={BWD_K}, M in {BWD_M} and a "
            f"map width that is a multiple of 4, not K={k}, M={m}, C={c}")
    upstream = upstream.reshape(1).to(torch.float32).contiguous()
    dw = torch.empty_like(wmap_tiles)
    dphi = torch.zeros((rhs.shape[0], k), device=dev)
    dg = torch.zeros((m, k), device=dev)
    gsplit = torch.empty(2 * m * m, device=dev)   # G's split B fragments
    ptr = kernels.ptr
    kernels.launch("lsv2_gram_bwd", ptr(seg_tiles), ptr(wmap_tiles),
                   ptr(rhs), ptr(gfull), t, c, m, k, lay, eps, inv_hw,
                   ptr(upstream), ptr(dw), ptr(dphi), ptr(dg), ptr(gsplit),
                   kernels.stream(dw))
    gram_tiles_bwd.launches += 1
    return dw, dphi, dg


gram_tiles_bwd.launches = 0


def bwd_occupancy(m: int) -> dict:
    """K6b's instantiation at G [m, m] (CUDA only): resident blocks and
    warps an SM, dynamic shared bytes, registers and local (spill, stack)
    bytes a thread, from the CUDA runtime."""
    return kernels.occupancy("lsv2_gram_bwd_occupancy", m)


def _check(seg_tiles, wmap_tiles, rhs, gfull):
    dev = wmap_tiles.device
    if dev.type != "cuda":
        raise ValueError(f"gram kernels: unsupported device {dev}")
    t, _, c = wmap_tiles.shape
    m = gfull.shape[0]
    if m % 16 or m > c:
        raise ValueError(f"G [{m}, {m}]: M must be a multiple of 16 and at "
                         f"most the map's {c} channels")
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
