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

Shapes: the kernel takes every L, K and PQ the Pallas kernel takes.
`kernel_plan` (a pure function of the shapes) says which of its two
designs a call runs and how the general one cuts the work: K padded to the
mma k-step, a level's [gram | phi] columns in n-tiles of 8 taken four at a
time (the prompts in chunks of 32), the levels one after another.
"""
from __future__ import annotations

import torch

from . import kernels

P = 256
KERNEL_K = 64     # the main path's design: codebook rows a level,
KERNEL_MAX_PQ = 16  # prompts a level
KERNEL_MAX_LEVELS = 3  # and levels (csrc/query.cu kK, kMaxPQ, kMaxLevels)
N_TILE = 8        # an mma n-tile's columns
N_GROUP = 4       # n-tiles a warp accumulates at once (query_frag.cuh)


def kernel_plan(L: int, K: int, PQ: int, bf16: bool) -> dict:
    """How the kernel computes raw and nrm2 for L levels of K codebook rows
    and PQ prompts a level (csrc/query.cu, query_frag.cuh): `route` "main"
    (K = 64, L <= 3, PQ <= 16: the main path's design) or "any"; for
    "any", the mma k-step (8 for the f32 map's TF32, 16 for bf16),
    `k_pad` = K rounded up to it, the gram n-tiles `nt_gram` = k_pad / 8
    and a level's n-tiles `nt` (then ceil(PQ / 8) of phi), `chunks`, the
    [first, end) n-tiles a warp accumulates at once, `pq_chunks`, the
    prompts [q0, q1) of each chunk that holds any, `levels`, the order the
    levels run in, and `frag_words`, the scratch of B's fragments (32-bit
    words)."""
    if min(L, K, PQ) < 1:
        raise ValueError(f"no query of L={L}, K={K}, PQ={PQ}")
    route = ("main" if K == KERNEL_K and L <= KERNEL_MAX_LEVELS
             and PQ <= KERNEL_MAX_PQ else "any")
    step = 16 if bf16 else 8
    k_pad = -(-K // step) * step
    nt_gram = k_pad // N_TILE
    nt = nt_gram + -(-PQ // N_TILE)
    chunks = [(a, min(a + N_GROUP, nt)) for a in range(0, nt, N_GROUP)]
    pq_chunks = [(max(a, nt_gram) * N_TILE - k_pad,
                  min(b * N_TILE - k_pad, PQ))
                 for a, b in chunks if b > nt_gram]
    return dict(route=route, k_step=step, k_pad=k_pad, nt_gram=nt_gram,
                nt=nt, chunks=chunks, pq_chunks=pq_chunks,
                levels=list(range(L)),
                frag_words=L * nt * (k_pad // step) * 32 * (2 if bf16 else 4))


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
    bf16 = dtype == torch.bfloat16
    plan = kernel_plan(L, K, PQ, bf16)
    # The main design loads the map 16 bytes at a time.
    if plan["route"] == "main" and wm_tiles.data_ptr() % 16 == 0:
        kernels.launch(name, ptr(wm_tiles), ptr(phi), ptr(gram), t, L, PQ,
                       ptr(raw), ptr(nrm2), kernels.stream(raw))
    else:
        frag = torch.empty(plan["frag_words"], dtype=torch.int32, device=dev)
        kernels.launch("lsv2_query_map_tiles_any", int(bf16),
                       ptr(wm_tiles), ptr(phi), ptr(gram), t, L, K, PQ,
                       ptr(raw), ptr(nrm2), ptr(frag), plan["frag_words"],
                       kernels.stream(raw))
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


def kernel_occupancy(bf16: bool, levels: int, pq: int, k: int = KERNEL_K
                     ) -> dict:
    """The kernel's mode (bf16 or f32 map) at L levels, PQ prompts and K
    codebook rows, in the design `kernel_plan` picks (CUDA only): resident
    blocks and warps an SM, dynamic shared bytes, registers and local
    (spill, stack) bytes a thread, from the CUDA runtime."""
    if kernel_plan(levels, k, pq, bf16)["route"] == "any":
        return kernels.occupancy("lsv2_query_any_occupancy", int(bf16))
    return kernels.occupancy("lsv2_query_occupancy", int(bf16), levels, pq)
