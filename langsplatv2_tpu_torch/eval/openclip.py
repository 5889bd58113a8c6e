"""Prompt encoding and relevancy maps
(port of langsplatv2_tpu/eval/openclip.py).

Backends: `HashBackend` (deterministic pseudo-embeddings, the default:
no CLIP weights exist offline), `OpenClipBackend` and
`TransformersBackend` (real encoders; their packages are imported when one
is built, and the weights must be on disk). JAX's `FlaxClipBackend` is its
TPU form of the transformers encoder; here `make_backend("flax")` raises
and names `transformers`.

The relevancy of decoded [L, H, W, 512] maps (`get_relevancy`,
`get_max_across`, `get_max_across_quick`, `get_semantic_map`) is JAX's
pairwise softmax(10 [pos, neg]) with the hardest negative. The serving
path computes relevancy straight from the rasterized coefficient map (the
Gram identity of the JAX `get_max_across_from_weights`): with
feat_l = C_l^T w,
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

from .. import tracing
from ..device import resolve_device
from ..ops import query, rasterize_tiles
from ..ops.rasterize import mark_stage

CLIP_DIM = 512
CANONICAL_NEGATIVES = ("object", "things", "stuff", "texture")


def _host(images) -> np.ndarray:
    return images.cpu().numpy() if torch.is_tensor(images) \
        else np.asarray(images)


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

    def encode_image(self, images) -> np.ndarray:
        """[B, 3, H, W] (numpy or a tensor) -> [B, 512], seeded by each
        image's bytes."""
        images = _host(images)
        flat = images.reshape(images.shape[0], -1)
        out = np.empty((len(flat), CLIP_DIM), np.float32)
        for i, row in enumerate(flat):
            seed = int.from_bytes(
                hashlib.sha256(row.tobytes()).digest()[:8], "little")
            v = np.random.default_rng(seed).standard_normal(CLIP_DIM)
            out[i] = v / np.linalg.norm(v)
        return out


class OpenClipBackend:
    """OpenCLIP ViT-B-16 laion2b_s34b_b88k (reference preprocess.py:28-30)
    on `device` (default CUDA). Raises ImportError / OSError when
    open_clip or its weights are absent."""

    name = "open_clip"

    def __init__(self, model_type="ViT-B-16", pretrained="laion2b_s34b_b88k",
                 device=None):
        self.device = resolve_device(device)
        import open_clip

        model, _, _ = open_clip.create_model_and_transforms(
            model_type, pretrained=pretrained)
        self.model = model.to(self.device).eval()
        self.tokenizer = open_clip.get_tokenizer(model_type)

    def encode_text(self, texts: list[str]) -> np.ndarray:
        with torch.no_grad():
            tok = torch.cat([self.tokenizer(p) for p in texts])
            return self.model.encode_text(
                tok.to(self.device)).float().cpu().numpy()

    def encode_image(self, images) -> np.ndarray:
        """[B, 3, H, W] in [0, 1] (numpy or a tensor) -> [B, D]."""
        x = torch.as_tensor(images, dtype=torch.float32, device=self.device)
        mean = torch.tensor([0.48145466, 0.4578275, 0.40821073],
                            device=self.device)
        std = torch.tensor([0.26862954, 0.26130258, 0.27577711],
                           device=self.device)
        x = (x - mean[:, None, None]) / std[:, None, None]
        with torch.no_grad():
            return self.model.encode_image(x).float().cpu().numpy()


class TransformersBackend:
    """HF CLIP (laion/CLIP-ViT-B-16-laion2B-s34b-b88k) via transformers,
    from the local cache only. `model` and `processor` may be passed in
    (a CLIPModel and a CLIPProcessor) instead of loaded."""

    name = "transformers"

    def __init__(self, model_id="laion/CLIP-ViT-B-16-laion2B-s34b-b88k",
                 model=None, processor=None, device=None):
        self.device = resolve_device(device)
        if model is None or processor is None:
            from transformers import CLIPModel, CLIPProcessor

            model = CLIPModel.from_pretrained(model_id,
                                              local_files_only=True)
            processor = CLIPProcessor.from_pretrained(model_id,
                                                      local_files_only=True)
        self.model = model.to(self.device)
        self.processor = processor

    def _on_device(self, inputs) -> dict:
        return {k: v.to(self.device) for k, v in inputs.items()}

    def encode_text(self, texts: list[str]) -> np.ndarray:
        inputs = self.processor(text=texts, return_tensors="pt", padding=True)
        with torch.no_grad():
            return self.model.get_text_features(
                **self._on_device(inputs)).cpu().numpy()

    def encode_image(self, images) -> np.ndarray:
        """The processor resizes and normalizes on the host; the model runs
        on the device."""
        inputs = self.processor(
            images=[im.transpose(1, 2, 0) for im in _host(images)],
            return_tensors="pt")
        with torch.no_grad():
            return self.model.get_image_features(
                **self._on_device(inputs)).cpu().numpy()


def make_backend(name: str = "hash", device=None):
    """"hash" (the default), "open_clip", "transformers", or "auto": the
    first real encoder that loads, else the hash backend. The real
    encoders run on `device` (default CUDA)."""
    if name == "hash":
        return HashBackend()
    if name == "open_clip":
        return OpenClipBackend(device=device)
    if name == "transformers":
        return TransformersBackend(device=device)
    if name == "flax":
        raise NotImplementedError(
            'the "flax" backend is JAX\'s form of the transformers encoder; '
            'in torch use make_backend("transformers")')
    if name != "auto":
        raise ValueError(f"unknown CLIP backend {name!r}")
    for cls in (OpenClipBackend, TransformersBackend):
        try:
            return cls(device=device)
        except Exception:
            continue
    return HashBackend()


class OpenCLIPNetwork:
    def __init__(self, backend: str = "hash", device=None):
        self.device = resolve_device(device)
        self.backend = make_backend(backend, device=self.device)
        self.negatives = CANONICAL_NEGATIVES
        self.positives: tuple[str, ...] = (" ",)
        self.neg_embeds = self._embed(list(self.negatives))
        self.pos_embeds = self._embed(list(self.positives))
        self.semantic_labels: tuple[str, ...] = ()
        self.semantic_embeds = None

    def _embed(self, texts: list[str]) -> torch.Tensor:
        e = self.encode_text(texts)
        return e / torch.linalg.norm(e, dim=-1, keepdim=True)

    def encode_text(self, texts: list[str]) -> torch.Tensor:
        """[len(texts), 512] f32 embeddings, not normalized."""
        return torch.from_numpy(self.backend.encode_text(texts)).to(
            self.device)

    def encode_image(self, images: np.ndarray) -> torch.Tensor:
        """[B, 3, H, W] images -> [B, 512] f32 embeddings."""
        return torch.from_numpy(np.asarray(
            self.backend.encode_image(images), np.float32)).to(self.device)

    def set_positives(self, texts: list[str]) -> None:
        self.positives = tuple(texts)
        self.pos_embeds = self._embed(list(texts))

    def set_semantics(self, texts: list[str]) -> None:
        self.semantic_labels = tuple(texts)
        self.semantic_embeds = self._embed(list(texts))

    def get_relevancy(self, embed: torch.Tensor,
                      positive_id: int) -> torch.Tensor:
        """embed [M, 512] -> [M, 2]: the pairwise softmax probabilities
        against the hardest negative (reference openclip_encoder.py:41-56)."""
        output = embed.to(self.device) @ self.phrases().T      # [M, P+N]
        pos = output[:, positive_id:positive_id + 1]
        neg = output[:, len(self.positives):]
        sims = torch.stack([pos.expand_as(neg), neg], dim=-1)  # [M, N, 2]
        softmax = torch.softmax(10.0 * sims, dim=-1)
        best = torch.argmin(softmax[..., 0], dim=1)
        return softmax[torch.arange(softmax.shape[0], device=self.device),
                       best]

    def get_max_across(self, sem_map: torch.Tensor) -> torch.Tensor:
        """sem_map [L, H, W, 512] -> relevancy [L, positives, H, W], a
        phrase at a time (reference get_max_across)."""
        n_levels, h, w, _ = sem_map.shape
        rows = []
        for i in range(n_levels):
            flat = sem_map[i].reshape(h * w, -1)
            rows.append(torch.stack([
                self.get_relevancy(flat, j)[:, 0]
                for j in range(len(self.positives))]))
        return torch.stack(rows).reshape(n_levels, len(self.positives), h, w)

    def get_max_across_quick(self, sem_map: torch.Tensor) -> torch.Tensor:
        """The same relevancy for all phrases at once, through a
        [L, H*W, P, N, 2] softmax (reference get_max_across_quick)."""
        n_levels, h, w, c = sem_map.shape
        n_phr, n_neg = len(self.positives), len(self.negatives)
        sim = torch.einsum("nqc,pc->nqp",
                           sem_map.to(self.device).reshape(n_levels, h * w, c),
                           self.phrases())
        pos, neg = sim[..., :n_phr], sim[..., n_phr:]
        shape = pos.shape + (n_neg,)
        sims = torch.stack([pos[..., None].expand(shape),
                            neg[:, :, None, :].expand(shape)], dim=-1)
        min_pos = torch.softmax(10.0 * sims, dim=-1)[..., 0].amin(dim=-1)
        return min_pos.permute(0, 2, 1).reshape(n_levels, n_phr, h, w)

    def get_semantic_map(self, sem_map: torch.Tensor) -> torch.Tensor:
        """Argmax labelling [L, H, W] over the semantic labels and the
        negatives; a negative's win becomes -1."""
        if self.semantic_embeds is None:
            raise ValueError("get_semantic_map needs set_semantics first")
        pos_num = self.semantic_embeds.shape[0]
        phrases = torch.cat([self.semantic_embeds, self.neg_embeds], dim=0)
        out = torch.einsum("nhwc,pc->nhwp", sem_map.to(self.device), phrases)
        pred = torch.argmax(out, dim=-1)
        return torch.where(pred >= pos_num, -1, pred)

    def phrases(self) -> torch.Tensor:
        """[P + N, 512]: positives, then the canonical negatives."""
        return torch.cat([self.pos_embeds, self.neg_embeds], dim=0)

    def prompt_constants(self, codebooks: torch.Tensor):
        """Per-prompt-set constants: phi [L, K, P+N] (codebooks folded into
        the phrases) and gram [L, K, K] (codebook Gram matrices), in the
        span "query"."""
        with tracing.span("query"):
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
        query kernel K3, in the span "query". `stage_events` (CUDA only)
        gets ("query", event) and ("relevancy", event) after each stage."""
        with tracing.span("query"):
            raw, nrm2 = query.query_map_tiles(wm_tiles, phi, gram)
            mark_stage(stage_events, "query")
            return self.relevancy_from_query(raw, nrm2, grid_x, grid_y,
                                             height, width, stage_events)

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
