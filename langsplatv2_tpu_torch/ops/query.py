"""Gram relevancy query over weight-map tiles (kernel K3)
(port of langsplatv2_tpu/ops/pallas_query.py).

On a CUDA tensor `query_map_tiles` launches csrc/query.cu; on a CPU tensor
it runs `query_map_tiles_plain`, one pair of matmuls per level. The kernel
is bound by the read of the f32 map; on CUDA cores, as written, its f32
multiply-adds take longer than that read. csrc/query.cu says more. The f32 map is the input of
this slice; the bf16 map of the JAX serving default is later work.
"""
from __future__ import annotations

import torch

from . import kernels

P = 256
KERNEL_K = 64     # codebook rows per level the kernel is built for
KERNEL_MAX_PQ = 16


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


def query_map_tiles(wm_tiles: torch.Tensor, phi: torch.Tensor,
                    gram: torch.Tensor):
    """wm_tiles [T, 256, L*K] f32, phi [L, K, PQ] f32, gram [L, K, K] f32
    -> (raw [T, 256, L*PQ], nrm2 [T, 256, L]) with
    raw[t,p,l*PQ+q] = sum_k wm[t,p,l*K+k] phi[l,k,q] and
    nrm2[t,p,l] = wm_l . (gram_l^T wm_l)."""
    dev = wm_tiles.device
    t, p, c = wm_tiles.shape
    L, K, PQ = phi.shape
    if p != P or c != L * K:
        raise ValueError(f"weight-map tiles {tuple(wm_tiles.shape)} do not "
                         f"match phi {tuple(phi.shape)}")
    if dev.type == "cpu":
        return query_map_tiles_plain(wm_tiles, phi, gram)
    if dev.type != "cuda":
        raise ValueError(f"query_map_tiles: unsupported device {dev}")
    if K != KERNEL_K or not 1 <= PQ <= KERNEL_MAX_PQ:
        raise NotImplementedError(
            f"the query kernel takes K={KERNEL_K} codebook rows and at most "
            f"{KERNEL_MAX_PQ} prompts a level, not K={K}, PQ={PQ}")
    kernels.check_tensor(wm_tiles, "wm_tiles", torch.float32, (t, P, c), dev)
    kernels.check_tensor(phi, "phi", torch.float32, (L, K, PQ), dev)
    kernels.check_tensor(gram, "gram", torch.float32, (L, K, K), dev)
    raw = torch.empty((t, P, L * PQ), device=dev)
    nrm2 = torch.empty((t, P, L), device=dev)
    ptr = kernels.ptr
    kernels.launch("lsv2_query_map_tiles", ptr(wm_tiles), ptr(phi),
                   ptr(gram), t, L, PQ, ptr(raw), ptr(nrm2),
                   kernels.stream(raw))
    query_map_tiles.launches += 1
    return raw, nrm2


query_map_tiles.launches = 0
