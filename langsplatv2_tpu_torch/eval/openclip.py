"""Prompt encoding and relevancy maps
(port of langsplatv2_tpu/eval/openclip.py:37-60, 180-306).

Only the deterministic hash backend is ported (no CLIP weights are
available offline); the real encoders are later work. Relevancy comes
straight from the rasterized coefficient map (the Gram identity of the JAX
`get_max_across_from_weights`): with feat_l = C_l^T w,
    sim = (w . (C_l phrase)) / sqrt(w^T (C_l C_l^T) w),
so the 512-d feature map is never built. `relevancy_from_tiles` computes
the two contractions with kernel K3 on the [T, 256, L*K] tile layout, and
`relevancy_from_query` turns them (or the fused query's, K2q) into
relevancy: softmax([10 pos, 10 neg])[0] = sigmoid(10 (pos - neg)), min
over the negatives = sigmoid against the largest negative.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch

from ..device import resolve_device
from ..ops import query, rasterize_tiles
from ..ops.rasterize import mark_stage

CLIP_DIM = 512
CANONICAL_NEGATIVES = ("object", "things", "stuff", "texture")


class HashBackend:
    """Deterministic unit-norm pseudo-embeddings from a SHA-256 of the
    text: stable across processes, not semantically meaningful."""

    name = "hash"

    def encode_text(self, texts: list[str]) -> np.ndarray:
        out = np.empty((len(texts), CLIP_DIM), np.float32)
        for i, t in enumerate(texts):
            seed = int.from_bytes(hashlib.sha256(t.encode()).digest()[:8],
                                  "little")
            v = np.random.default_rng(seed).standard_normal(CLIP_DIM)
            out[i] = v / np.linalg.norm(v)
        return out


def make_backend(name: str = "hash"):
    if name == "hash":
        return HashBackend()
    raise NotImplementedError(
        f"CLIP backend {name!r} belongs to a later slice of the port "
        "(eval drivers, ROADMAP.md Queue 1 item 10); this slice has 'hash'")


class OpenCLIPNetwork:
    def __init__(self, backend: str = "hash", device=None):
        self.device = resolve_device(device)
        self.backend = make_backend(backend)
        self.negatives = CANONICAL_NEGATIVES
        self.positives: tuple[str, ...] = (" ",)
        self.neg_embeds = self._embed(list(self.negatives))
        self.pos_embeds = self._embed(list(self.positives))

    def _embed(self, texts: list[str]) -> torch.Tensor:
        e = self.encode_text(texts)
        return e / torch.linalg.norm(e, dim=-1, keepdim=True)

    def encode_text(self, texts: list[str]) -> torch.Tensor:
        """[len(texts), 512] f32 embeddings, not normalized."""
        return torch.from_numpy(self.backend.encode_text(texts)).to(
            self.device)

    def set_positives(self, texts: list[str]) -> None:
        self.positives = tuple(texts)
        self.pos_embeds = self._embed(list(texts))

    def phrases(self) -> torch.Tensor:
        """[P + N, 512]: positives, then the canonical negatives."""
        return torch.cat([self.pos_embeds, self.neg_embeds], dim=0)

    def prompt_constants(self, codebooks: torch.Tensor):
        """Per-prompt-set constants: phi [L, K, P+N] (codebooks folded into
        the phrases) and gram [L, K, K] (codebook Gram matrices)."""
        codebooks = codebooks.to(self.device)
        phi = torch.einsum("lkd,pd->lkp", codebooks, self.phrases())
        gram = torch.einsum("lkd,lmd->lkm", codebooks, codebooks)
        return phi.contiguous(), gram.contiguous()

    def _relevancy(self, raw: torch.Tensor, nrm2: torch.Tensor):
        """raw [L, Q, P+N], nrm2 [L, Q] -> [L, Q, P] relevancy."""
        n_phr = len(self.positives)
        sim = raw / (torch.sqrt(torch.clamp(nrm2, min=0.0))[..., None] + 1e-10)
        pos, neg = sim[..., :n_phr], sim[..., n_phr:]
        return torch.sigmoid(10.0 * (pos - neg.max(dim=-1, keepdim=True).values))

    def get_max_across_from_weights(self, weight_map: torch.Tensor,
                                    codebooks: torch.Tensor) -> torch.Tensor:
        """weight_map [L*K, H, W] -> relevancy [L, positives, H, W]."""
        L, K, _ = codebooks.shape
        h, w = weight_map.shape[1:]
        phi, gram = self.prompt_constants(codebooks)
        wm = weight_map.reshape(L, K, h * w)
        raw = torch.einsum("lkq,lkp->lqp", wm, phi)
        nrm2 = torch.einsum("lkq,lkm,lmq->lq", wm, gram, wm)
        relev = self._relevancy(raw, nrm2)
        return relev.permute(0, 2, 1).reshape(L, len(self.positives), h, w)

    def relevancy_from_tiles(self, wm_tiles: torch.Tensor, phi: torch.Tensor,
                             gram: torch.Tensor, grid_x: int, grid_y: int,
                             height: int, width: int,
                             stage_events: list | None = None):
        """wm_tiles [T, 256, L*K] (rasterize with assemble=False) and the
        prompt_constants -> relevancy [L, positives, H, W], through the
        query kernel K3. `stage_events` (CUDA only) gets ("query", event)
        and ("relevancy", event) after each stage."""
        raw, nrm2 = query.query_map_tiles(wm_tiles, phi, gram)
        mark_stage(stage_events, "query")
        return self.relevancy_from_query(raw, nrm2, grid_x, grid_y, height,
                                         width, stage_events)

    def relevancy_from_query(self, raw: torch.Tensor, nrm2: torch.Tensor,
                             grid_x: int, grid_y: int, height: int,
                             width: int, stage_events: list | None = None):
        """raw [T, 256, L*(P+N)] and nrm2 [T, 256, L] (K3's or the fused
        query's outputs) -> relevancy [L, positives, H, W]; `stage_events`
        gets ("relevancy", event)."""
        t, p, L = nrm2.shape
        relev = self._relevancy(raw.reshape(t * p, L, -1).transpose(0, 1),
                                nrm2.reshape(t * p, L).T)      # [L, Q, P]
        n_phr = len(self.positives)
        heat = rasterize_tiles.tiles_to_image(
            relev.permute(1, 0, 2).reshape(t, p, L * n_phr), grid_x, grid_y,
            height, width)
        mark_stage(stage_events, "relevancy")
        return heat.reshape(L, n_phr, height, width)
