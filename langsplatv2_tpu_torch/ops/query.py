"""Gram relevancy query over weight-map tiles (kernel K3)
(port of langsplatv2_tpu/ops/pallas_query.py).

On a CUDA tensor `query_map_tiles` launches csrc/query.cu; on a CPU tensor
it runs `query_map_tiles_plain`, one pair of matmuls per level. The kernel
is bound by the read of the map; its products run on the tensor cores (bf16
map: bf16 operands, f32 sums; f32 map: 3xTF32). csrc/query.cu says more.

A bf16 map (the fast16 serving tiles) goes to `query_map_tiles_bf16`, the
kernel's bf16 mode. As in the Pallas kernel (`mm_dt`), phi and gram are
then rounded to bf16 too, the products accumulate in f32 and nrm2's band
sum runs at f32: its plain version is `query_map_tiles_plain` on the
widened map and the rounded constants.
"""
from __future__ import annotations

import torch

from . import kernels

P = 256
KERNEL_K = 64     # codebook rows per level the kernel is built for
KERNEL_MAX_PQ = 16
KERNEL_MAX_LEVELS = 3


def query_map_tiles_plain(wm_tiles, phi, gram):
    t, p, c = wm_tiles.shape
    L, K, PQ = phi.shape
    wm = wm_tiles.reshape(t * p, L, K)
    raws, nrms = [], []
    for lvl in range(L):
        w = wm[:, lvl]
        raws.append(w @ phi[lvl])
        nrms.append(((w @ gram[lvl]) * w).sum(dim=-1))
    raw = torch.stack(raws, dim=1).reshape(t, p, L * PQ)
    return raw, torch.stack(nrms, dim=1).reshape(t, p, L)


def round_bf16(x):
    """x rounded to bf16 (nearest even) and widened back to f32."""
    return x.to(torch.bfloat16).float()


def query_map_tiles_bf16_plain(wm_tiles, phi, gram):
    return query_map_tiles_plain(wm_tiles.float(), round_bf16(phi),
                                 round_bf16(gram))


def _check(wm_tiles, phi):
    t, p, c = wm_tiles.shape
    L, K, PQ = phi.shape
    if p != P or c != L * K:
        raise ValueError(f"weight-map tiles {tuple(wm_tiles.shape)} do not "
                         f"match phi {tuple(phi.shape)}")
    if wm_tiles.device.type == "cuda" and (
            K != KERNEL_K or not 1 <= PQ <= KERNEL_MAX_PQ
            or not 1 <= L <= KERNEL_MAX_LEVELS):
        raise NotImplementedError(
            f"the query kernel takes K={KERNEL_K} codebook rows, at most "
            f"{KERNEL_MAX_LEVELS} levels and {KERNEL_MAX_PQ} prompts a "
            f"level, not K={K}, L={L}, PQ={PQ}")
    if wm_tiles.device.type not in ("cpu", "cuda"):
        raise ValueError(f"query_map_tiles: unsupported device "
                         f"{wm_tiles.device}")


def _launch(name, wm_tiles, phi, gram, dtype):
    dev = wm_tiles.device
    t, _, c = wm_tiles.shape
    L, K, PQ = phi.shape
    kernels.check_tensor(wm_tiles, "wm_tiles", dtype, (t, P, c), dev)
    kernels.check_tensor(phi, "phi", torch.float32, (L, K, PQ), dev)
    kernels.check_tensor(gram, "gram", torch.float32, (L, K, K), dev)
    raw = torch.empty((t, P, L * PQ), device=dev)
    nrm2 = torch.empty((t, P, L), device=dev)
    ptr = kernels.ptr
    kernels.launch(name, ptr(wm_tiles), ptr(phi), ptr(gram), t, L, PQ,
                   ptr(raw), ptr(nrm2), kernels.stream(raw))
    return raw, nrm2


def query_map_tiles(wm_tiles: torch.Tensor, phi: torch.Tensor,
                    gram: torch.Tensor):
    """wm_tiles [T, 256, L*K] f32 or bf16, phi [L, K, PQ] f32, gram
    [L, K, K] f32 -> (raw [T, 256, L*PQ], nrm2 [T, 256, L]) f32 with
    raw[t,p,l*PQ+q] = sum_k wm[t,p,l*K+k] phi[l,k,q] and
    nrm2[t,p,l] = wm_l . (gram_l^T wm_l). A bf16 map goes to
    `query_map_tiles_bf16`."""
    if wm_tiles.dtype == torch.bfloat16:
        return query_map_tiles_bf16(wm_tiles, phi, gram)
    _check(wm_tiles, phi)
    if wm_tiles.device.type == "cpu":
        return query_map_tiles_plain(wm_tiles, phi, gram)
    out = _launch("lsv2_query_map_tiles", wm_tiles, phi, gram, torch.float32)
    query_map_tiles.launches += 1
    return out


query_map_tiles.launches = 0


def query_map_tiles_bf16(wm_tiles: torch.Tensor, phi: torch.Tensor,
                         gram: torch.Tensor):
    """The query on a bf16 map, with phi and gram rounded to bf16."""
    _check(wm_tiles, phi)
    if wm_tiles.device.type == "cpu":
        return query_map_tiles_bf16_plain(wm_tiles, phi, gram)
    out = _launch("lsv2_query_map_tiles_bf16", wm_tiles,
                  round_bf16(phi).contiguous(), round_bf16(gram).contiguous(),
                  torch.bfloat16)
    query_map_tiles_bf16.launches += 1
    return out


query_map_tiles_bf16.launches = 0


def kernel_occupancy(bf16: bool, levels: int, pq: int) -> dict:
    """The kernel's mode (bf16 or f32 map) at L levels and PQ prompts (CUDA
    only): resident blocks and warps an SM, dynamic shared bytes, registers
    and local (spill, stack) bytes a thread, from the CUDA runtime."""
    return kernels.occupancy("lsv2_query_occupancy", int(bf16), levels, pq)
