"""Segment Anything in torch (port of langsplatv2_tpu/preprocess/sam_jax.py)
and its automatic 4-granularity mask generator.

The modules are upstream segment_anything's tree, so `state_dict()` has
the keys of `sam_vit_h_4b8939.pth` and a real checkpoint loads with
`load_state_dict(strict=True)` (`Sam.from_checkpoint`):

- `ImageEncoderViT`: a patch-embed conv, ViT blocks (windowed, or global
  at `global_attn_indexes`) with decomposed relative positions, and a
  256-channel neck; LayerNorm eps 1e-6 there, exact-erf GELU;
- `PromptEncoder`: random-Fourier point embeddings, the point and
  not-a-point embeddings, the no-mask embedding (`mask_downscaling` is
  part of the checkpoint and unused here, as in JAX);
- `MaskDecoder`: an IoU token and 4 mask tokens through the two-way
  transformer (LayerNorm eps 1e-5, the first layer skips the PE),
  transposed-conv upscaling, per-token hypernetwork MLPs.

`Sam.decode_masks` is JAX's `decode_masks`: one positive point a prompt,
all 1 + 3 mask tokens returned. `state_dict_from_jax_params` turns JAX's
`init_params` pytree (as numpy) into this state dict, the inverse of
JAX's `convert_torch_checkpoint`. `init_weights` draws JAX's random
initialization (N(0, 0.02) dense weights) from a torch.Generator.

`TorchSamMaskGenerator` is JAX's `JaxSamMaskGenerator`: a point grid
over the valid region, batched decodes, each logit map upscaled to the
image (`resize.resize_linear_f32`, cv2's INTER_LINEAR), the thresholds,
area and stability counts and the boxes computed for the whole batch on
the device; a box NMS a level on the host; only the kept masks leave the
device. `generate(image)` returns the langsplat fork's 4-tuple
(default, s, m, l) of mask dicts.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..device import resolve_device
from .resize import resize_linear_f32, resize_linear_u8


@dataclasses.dataclass(frozen=True)
class SamConfig:
    img_size: int = 1024
    patch_size: int = 16
    encoder_dim: int = 1280        # ViT-H
    encoder_depth: int = 32
    encoder_heads: int = 16
    global_attn_indexes: tuple = (7, 15, 23, 31)
    window_size: int = 14
    prompt_dim: int = 256          # transformer/prompt embedding dim
    decoder_depth: int = 2
    decoder_heads: int = 8
    decoder_mlp_dim: int = 2048
    num_multimask: int = 3         # s / m / l granularity tokens
    mask_threshold: float = 0.0

    @property
    def grid(self) -> int:
        return self.img_size // self.patch_size


VIT_H = SamConfig()
VIT_TINY_TEST = SamConfig(
    img_size=64, patch_size=8, encoder_dim=32, encoder_depth=2,
    encoder_heads=2, global_attn_indexes=(1,), window_size=4,
    prompt_dim=32, decoder_mlp_dim=64)

PIXEL_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
PIXEL_STD = np.array([58.395, 57.12, 57.375], np.float32)


# ------------------------------------------------------------ the modules

class LayerNorm2d(nn.Module):
    """Channel LayerNorm on NCHW (segment_anything common.LayerNorm2d)."""

    def __init__(self, ch: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.eps = eps

    def forward(self, x):
        u = x.mean(1, keepdim=True)
        s = (x - u).pow(2).mean(1, keepdim=True)
        x = (x - u) / torch.sqrt(s + self.eps)
        return self.weight[:, None, None] * x + self.bias[:, None, None]


class MLPBlock(nn.Module):
    def __init__(self, dim: int, mlp_dim: int, act=nn.GELU):
        super().__init__()
        self.lin1 = nn.Linear(dim, mlp_dim)
        self.lin2 = nn.Linear(mlp_dim, dim)
        self.act = act()

    def forward(self, x):
        return self.lin2(self.act(self.lin1(x)))


def _rel_pos_bias(q, rel_h, rel_w, h: int, w: int):
    """Decomposed relative positions: q.Rh + q.Rw, [B, h*w, h*w] for q
    [B, h*w, C] and tables indexed by coordinate delta."""
    if rel_h.shape[0] != 2 * h - 1 or rel_w.shape[0] != 2 * w - 1:
        raise ValueError("relative-position tables do not fit the window")
    dev = q.device
    idx_h = (torch.arange(h, device=dev)[:, None]
             - torch.arange(h, device=dev)[None, :] + (h - 1))
    idx_w = (torch.arange(w, device=dev)[:, None]
             - torch.arange(w, device=dev)[None, :] + (w - 1))
    r_q = q.reshape(q.shape[0], h, w, -1)
    bh = torch.einsum("bhwc,hkc->bhwk", r_q, rel_h[idx_h])
    bw = torch.einsum("bhwc,wkc->bhwk", r_q, rel_w[idx_w])
    return (bh[..., :, None] + bw[..., None, :]).reshape(-1, h * w, h * w)


class Attention(nn.Module):
    """Encoder multi-head attention with decomposed relative positions."""

    def __init__(self, dim: int, heads: int, input_size: int):
        super().__init__()
        self.num_heads = heads
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)
        hd = dim // heads
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size - 1, hd))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size - 1, hd))

    def forward(self, x):
        b, h, w, _ = x.shape
        nh = self.num_heads
        qkv = self.qkv(x).reshape(b, h * w, 3, nh, -1).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.reshape(3, b * nh, h * w, -1).unbind(0)
        attn = (q @ k.transpose(-2, -1)) * (q.shape[-1] ** -0.5)
        attn = attn + _rel_pos_bias(q, self.rel_pos_h, self.rel_pos_w, h, w)
        attn = attn.softmax(dim=-1)
        x = (attn @ v).view(b, nh, h, w, -1).permute(0, 2, 3, 1, 4)
        return self.proj(x.reshape(b, h, w, -1))


def window_partition(x, ws: int):
    b, h, w, c = x.shape
    ph, pw = (ws - h % ws) % ws, (ws - w % ws) % ws
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, w + pw
    x = x.view(b, hp // ws, ws, wp // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, c), (hp, wp)


def window_unpartition(win, ws: int, pad_hw, hw):
    hp, wp = pad_hw
    h, w = hw
    b = win.shape[0] // (hp * wp // ws // ws)
    x = win.view(b, hp // ws, wp // ws, ws, ws, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)
    return x[:, :h, :w, :].contiguous()


class Block(nn.Module):
    """Pre-LN transformer block; windowed unless window_size is 0."""

    def __init__(self, dim: int, heads: int, window_size: int,
                 input_size: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, heads,
                              window_size if window_size > 0 else input_size)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = MLPBlock(dim, 4 * dim)
        self.window_size = window_size

    def forward(self, x):
        shortcut = x
        x = self.norm1(x)
        if self.window_size > 0:
            h, w = x.shape[1], x.shape[2]
            x, pad_hw = window_partition(x, self.window_size)
        x = self.attn(x)
        if self.window_size > 0:
            x = window_unpartition(x, self.window_size, pad_hw, (h, w))
        x = shortcut + x
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, kernel_size=patch, stride=patch)

    def forward(self, x):
        return self.proj(x).permute(0, 2, 3, 1)


class ImageEncoderViT(nn.Module):
    def __init__(self, cfg: SamConfig):
        super().__init__()
        g, d = cfg.grid, cfg.encoder_dim
        self.patch_embed = PatchEmbed(cfg.patch_size, d)
        self.pos_embed = nn.Parameter(torch.zeros(1, g, g, d))
        self.blocks = nn.ModuleList([
            Block(d, cfg.encoder_heads,
                  0 if i in cfg.global_attn_indexes else cfg.window_size, g)
            for i in range(cfg.encoder_depth)])
        self.neck = nn.Sequential(
            nn.Conv2d(d, cfg.prompt_dim, 1, bias=False),
            LayerNorm2d(cfg.prompt_dim),
            nn.Conv2d(cfg.prompt_dim, cfg.prompt_dim, 3, padding=1,
                      bias=False),
            LayerNorm2d(cfg.prompt_dim))

    def forward(self, x):
        """x [B, 3, S, S] normalized -> [B, prompt_dim, G, G]."""
        x = self.patch_embed(x) + self.pos_embed
        for blk in self.blocks:
            x = blk(x)
        return self.neck(x.permute(0, 3, 1, 2))


class PositionEmbeddingRandom(nn.Module):
    def __init__(self, num_pos_feats: int):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix",
                             torch.randn(2, num_pos_feats))

    def encode(self, coords):
        """[..., 2] coordinates in [0, 1] -> [..., 2 num_pos_feats]."""
        proj = (2.0 * coords - 1.0) @ self.positional_encoding_gaussian_matrix
        proj = proj * (2.0 * np.pi)
        return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)


class PromptEncoder(nn.Module):
    def __init__(self, p: int, mask_in_chans: int = 16):
        super().__init__()
        self.pe_layer = PositionEmbeddingRandom(p // 2)
        self.point_embeddings = nn.ModuleList(
            [nn.Embedding(1, p) for _ in range(4)])
        self.not_a_point_embed = nn.Embedding(1, p)
        self.mask_downscaling = nn.Sequential(
            nn.Conv2d(1, mask_in_chans // 4, 2, 2),
            LayerNorm2d(mask_in_chans // 4), nn.GELU(),
            nn.Conv2d(mask_in_chans // 4, mask_in_chans, 2, 2),
            LayerNorm2d(mask_in_chans), nn.GELU(),
            nn.Conv2d(mask_in_chans, p, 1))
        self.no_mask_embed = nn.Embedding(1, p)


class DecAttention(nn.Module):
    """Two-way transformer attention (an optional downsampled width)."""

    def __init__(self, dim: int, heads: int, downsample_rate: int = 1):
        super().__init__()
        self.internal_dim = dim // downsample_rate
        self.num_heads = heads
        self.q_proj = nn.Linear(dim, self.internal_dim)
        self.k_proj = nn.Linear(dim, self.internal_dim)
        self.v_proj = nn.Linear(dim, self.internal_dim)
        self.out_proj = nn.Linear(self.internal_dim, dim)

    def forward(self, q, k, v):
        b, nq, _ = q.shape
        nk = k.shape[1]
        nh = self.num_heads
        hd = self.internal_dim // nh
        q = self.q_proj(q).reshape(b, nq, nh, hd).transpose(1, 2)
        k = self.k_proj(k).reshape(b, nk, nh, hd).transpose(1, 2)
        v = self.v_proj(v).reshape(b, nk, nh, hd).transpose(1, 2)
        attn = torch.softmax((q @ k.transpose(-2, -1)) * hd ** -0.5, dim=-1)
        out = (attn @ v).transpose(1, 2).reshape(b, nq, self.internal_dim)
        return self.out_proj(out)


class TwoWayAttentionBlock(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_dim: int,
                 skip_first_layer_pe: bool):
        super().__init__()
        self.self_attn = DecAttention(dim, heads)
        self.norm1 = nn.LayerNorm(dim)
        self.cross_attn_token_to_image = DecAttention(dim, heads, 2)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = MLPBlock(dim, mlp_dim, nn.ReLU)
        self.norm3 = nn.LayerNorm(dim)
        self.norm4 = nn.LayerNorm(dim)
        self.cross_attn_image_to_token = DecAttention(dim, heads, 2)
        self.skip_first_layer_pe = skip_first_layer_pe

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)
        q, k = queries + query_pe, keys + key_pe
        queries = self.norm2(
            queries + self.cross_attn_token_to_image(q, k, keys))
        queries = self.norm3(queries + self.mlp(queries))
        q, k = queries + query_pe, keys + key_pe
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, q, queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self, depth: int, dim: int, heads: int, mlp_dim: int):
        super().__init__()
        self.layers = nn.ModuleList([
            TwoWayAttentionBlock(dim, heads, mlp_dim, i == 0)
            for i in range(depth)])
        self.final_attn_token_to_image = DecAttention(dim, heads, 2)
        self.norm_final_attn = nn.LayerNorm(dim)

    def forward(self, src, pos, tokens):
        """src, pos [B, HW, C]; tokens [B, T, C]."""
        queries, keys = tokens, src
        for layer in self.layers:
            queries, keys = layer(queries, keys, tokens, pos)
        q, k = queries + tokens, keys + pos
        queries = queries + self.final_attn_token_to_image(q, k, keys)
        return self.norm_final_attn(queries), keys


class MLP(nn.Module):
    """segment_anything mask_decoder.MLP at 3 layers, ReLU between."""

    def __init__(self, d_in: int, hidden: int, d_out: int):
        super().__init__()
        self.layers = nn.ModuleList(
            [nn.Linear(d_in, hidden), nn.Linear(hidden, hidden),
             nn.Linear(hidden, d_out)])

    def forward(self, x):
        x = F.relu(self.layers[0](x))
        x = F.relu(self.layers[1](x))
        return self.layers[2](x)


class MaskDecoder(nn.Module):
    def __init__(self, cfg: SamConfig):
        super().__init__()
        p = cfg.prompt_dim
        n_tok = 1 + cfg.num_multimask
        self.transformer = TwoWayTransformer(
            cfg.decoder_depth, p, cfg.decoder_heads, cfg.decoder_mlp_dim)
        self.iou_token = nn.Embedding(1, p)
        self.mask_tokens = nn.Embedding(n_tok, p)
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(p, p // 4, 2, stride=2),
            LayerNorm2d(p // 4), nn.GELU(),
            nn.ConvTranspose2d(p // 4, p // 8, 2, stride=2), nn.GELU())
        self.output_hypernetworks_mlps = nn.ModuleList(
            [MLP(p, p, p // 8) for _ in range(n_tok)])
        self.iou_prediction_head = MLP(p, p, n_tok)


class Sam(nn.Module):
    """The three parts under upstream's names (`image_encoder`,
    `prompt_encoder`, `mask_decoder`)."""

    def __init__(self, cfg: SamConfig = VIT_H):
        super().__init__()
        self.cfg = cfg
        self.image_encoder = ImageEncoderViT(cfg)
        self.prompt_encoder = PromptEncoder(cfg.prompt_dim)
        self.mask_decoder = MaskDecoder(cfg)

    @classmethod
    def from_checkpoint(cls, path: str, cfg: SamConfig = VIT_H,
                        device=None) -> "Sam":
        """An upstream `sam_vit_*.pth` state dict, loaded strict."""
        model = cls(cfg)
        sd = torch.load(path, map_location="cpu", weights_only=True)
        model.load_state_dict(sd, strict=True)
        return model.to(resolve_device(device)).eval()

    def encode_image(self, x: torch.Tensor) -> torch.Tensor:
        """x [S, S, 3] f32 (normalized, padded) -> [G, G, prompt_dim]."""
        return self.image_encoder(x.permute(2, 0, 1)[None])[0].permute(1, 2, 0)

    def decode_masks(self, embed: torch.Tensor, points: torch.Tensor,
                     labels: torch.Tensor):
        """embed [G, G, P]; points [B, 1, 2] in [0, 1] image coordinates;
        labels [B, 1] (1 positive). Returns (logits [B, 1 + M, 4G, 4G],
        iou_pred [B, 1 + M]), as JAX's decode_masks."""
        pe = self.prompt_encoder
        dec = self.mask_decoder
        g, _, p = embed.shape
        b = points.shape[0]
        dev = embed.device
        pt = pe.pe_layer.encode(points)                       # [B, 1, P]
        pt = pt + torch.where(labels[..., None] > 0,
                              pe.point_embeddings[1].weight[0],
                              pe.point_embeddings[0].weight[0])
        pad = pe.not_a_point_embed.weight[0].expand(b, 1, p)
        sparse = torch.cat([pt, pad], dim=1)                  # [B, 2, P]
        out_tokens = torch.cat([dec.iou_token.weight,
                                dec.mask_tokens.weight], dim=0)
        tokens = torch.cat([out_tokens.expand(b, -1, -1), sparse], dim=1)

        ar = (torch.arange(g, device=dev, dtype=torch.float32) + 0.5) / g
        yy, xx = torch.meshgrid(ar, ar, indexing="ij")
        img_pe = pe.pe_layer.encode(torch.stack([xx, yy], dim=-1))
        src = (embed + pe.no_mask_embed.weight[0]).reshape(1, g * g, p)
        hs, keys = dec.transformer(src.expand(b, -1, -1),
                                   img_pe.reshape(1, g * g, p).expand(b, -1, -1),
                                   tokens)
        n_tok = dec.mask_tokens.num_embeddings
        feat = keys.transpose(1, 2).reshape(b, p, g, g)
        feat = dec.output_upscaling(feat)                     # [B, P/8, 4G, 4G]
        hyper = torch.stack([dec.output_hypernetworks_mlps[i](hs[:, 1 + i])
                             for i in range(n_tok)], dim=1)   # [B, T, P/8]
        c, h4, w4 = feat.shape[1:]
        masks = (hyper @ feat.reshape(b, c, h4 * w4)).reshape(b, -1, h4, w4)
        return masks, dec.iou_prediction_head(hs[:, 0])


# ------------------------------------------------------ weights, JAX layout

def init_weights(model: Sam, generator: torch.Generator) -> Sam:
    """JAX's `init_params` distribution drawn from `generator`: dense,
    conv, table and token weights N(0, 0.02), the Fourier matrix N(0, 1),
    biases 0, norms 1 / 0."""
    with torch.no_grad():
        for name, prm in model.named_parameters():
            if name.endswith(".bias") or "norm" in name or "neck.1" in name \
                    or "neck.3" in name or "output_upscaling.1" in name:
                prm.fill_(1.0 if name.endswith("weight") else 0.0)
                continue
            prm.copy_(torch.randn(prm.shape, generator=generator,
                                  device=generator.device).to(prm.device)
                      * 0.02)
        buf = model.prompt_encoder.pe_layer.positional_encoding_gaussian_matrix
        buf.copy_(torch.randn(buf.shape, generator=generator,
                              device=generator.device).to(buf.device))
    return model


def state_dict_from_jax_params(params, cfg: SamConfig) -> dict:
    """JAX `init_params` / `convert_torch_checkpoint` pytree (numpy leaves)
    -> this module's state dict (upstream's keys): linear weights
    transposed back to [out, in], HWIO convs to OIHW, the transposed
    convs' [kh, kw, out, in] to ConvTranspose2d's [in, out, kh, kw].
    `mask_downscaling`, which JAX does not hold, is left at zeros."""
    sd = {}

    def t(x):
        return torch.from_numpy(np.array(x, np.float32))

    def dense(prefix, prm):
        sd[prefix + ".weight"] = t(np.asarray(prm["w"]).T)
        sd[prefix + ".bias"] = t(prm["b"])

    def ln(prefix, prm):
        sd[prefix + ".weight"] = t(prm["scale"])
        sd[prefix + ".bias"] = t(prm["bias"])

    def conv(x):  # HWIO -> OIHW
        return t(np.transpose(np.asarray(x), (3, 2, 0, 1)))

    enc = params["encoder"]
    e = "image_encoder."
    sd[e + "patch_embed.proj.weight"] = conv(enc["patch"]["w"])
    sd[e + "patch_embed.proj.bias"] = t(enc["patch"]["b"])
    sd[e + "pos_embed"] = t(enc["pos"])[None]
    for i, blk in enumerate(enc["blocks"]):
        b = f"{e}blocks.{i}."
        ln(b + "norm1", blk["ln1"])
        ln(b + "norm2", blk["ln2"])
        dense(b + "attn.qkv", blk["qkv"])
        dense(b + "attn.proj", blk["proj"])
        dense(b + "mlp.lin1", blk["mlp1"])
        dense(b + "mlp.lin2", blk["mlp2"])
        sd[b + "attn.rel_pos_h"] = t(blk["rel_h"])
        sd[b + "attn.rel_pos_w"] = t(blk["rel_w"])
    sd[e + "neck.0.weight"] = conv(enc["neck0"])
    ln(e + "neck.1", enc["neck_ln0"])
    sd[e + "neck.2.weight"] = conv(enc["neck1"])
    ln(e + "neck.3", enc["neck_ln1"])

    pr = params["prompt"]
    sd["prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"] = \
        t(pr["pe_gauss"])
    for i in range(4):
        sd[f"prompt_encoder.point_embeddings.{i}.weight"] = \
            t(pr["point_embed"])[i][None]
    sd["prompt_encoder.not_a_point_embed.weight"] = t(pr["not_a_point"])[None]
    sd["prompt_encoder.no_mask_embed.weight"] = t(pr["no_mask"])[None]
    for name, v in PromptEncoder(cfg.prompt_dim).mask_downscaling \
            .state_dict().items():
        sd["prompt_encoder.mask_downscaling." + name] = torch.zeros_like(v)

    dec = params["decoder"]
    d = "mask_decoder."

    def attn(prefix, prm):
        for k, v in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                     ("out", "out_proj")):
            dense(f"{prefix}.{v}", prm[k])

    for i, lyr in enumerate(dec["layers"]):
        b = f"{d}transformer.layers.{i}."
        attn(b + "self_attn", lyr["self_attn"])
        ln(b + "norm1", lyr["ln1"])
        attn(b + "cross_attn_token_to_image", lyr["cross_t2i"])
        ln(b + "norm2", lyr["ln2"])
        dense(b + "mlp.lin1", lyr["mlp1"])
        dense(b + "mlp.lin2", lyr["mlp2"])
        ln(b + "norm3", lyr["ln3"])
        attn(b + "cross_attn_image_to_token", lyr["cross_i2t"])
        ln(b + "norm4", lyr["ln4"])
    attn(d + "transformer.final_attn_token_to_image", dec["final_t2i"])
    ln(d + "transformer.norm_final_attn", dec["ln_final"])
    sd[d + "iou_token.weight"] = t(dec["iou_token"])[None]
    sd[d + "mask_tokens.weight"] = t(dec["mask_tokens"])
    # [kh, kw, out, in] -> ConvTranspose2d [in, out, kh, kw]
    sd[d + "output_upscaling.0.weight"] = t(
        np.transpose(np.asarray(dec["up0"]), (3, 2, 0, 1)))
    sd[d + "output_upscaling.0.bias"] = t(dec["up0_b"])
    ln(d + "output_upscaling.1", dec["up_ln"])
    sd[d + "output_upscaling.3.weight"] = t(
        np.transpose(np.asarray(dec["up1"]), (3, 2, 0, 1)))
    sd[d + "output_upscaling.3.bias"] = t(dec["up1_b"])
    for i, h in enumerate(dec["hyper"]):
        for j in range(3):
            dense(f"{d}output_hypernetworks_mlps.{i}.layers.{j}", h[f"l{j}"])
    for j in range(3):
        dense(f"{d}iou_prediction_head.layers.{j}", dec["iou_mlp"][f"l{j}"])
    return sd


# ------------------------------------------- automatic 4-granularity masks

def _box_nms(boxes: np.ndarray, scores: np.ndarray, thr: float) -> list[int]:
    order = np.argsort(-scores)
    keep = []
    x0, y0 = boxes[:, 0], boxes[:, 1]
    x1, y1 = boxes[:, 0] + boxes[:, 2], boxes[:, 1] + boxes[:, 3]
    area = boxes[:, 2] * boxes[:, 3]
    while len(order):
        i = order[0]
        keep.append(int(i))
        rest = order[1:]
        iw = np.maximum(
            0, np.minimum(x1[i], x1[rest]) - np.maximum(x0[i], x0[rest]))
        ih = np.maximum(
            0, np.minimum(y1[i], y1[rest]) - np.maximum(y0[i], y0[rest]))
        inter = iw * ih
        iou = inter / np.maximum(area[i] + area[rest] - inter, 1)
        order = rest[iou <= thr]
    return keep


def boxes_from_masks(seg: torch.Tensor) -> torch.Tensor:
    """seg [..., H, W] bool -> [..., 4] int64 (x0, y0, w, h) of the true
    pixels, zeros for an empty mask (JAX's `_box_from_mask`)."""
    h, w = seg.shape[-2:]
    dev = seg.device
    rows, cols = seg.any(dim=-1), seg.any(dim=-2)
    ar_h = torch.arange(h, device=dev)
    ar_w = torch.arange(w, device=dev)
    y0 = torch.where(rows, ar_h, h).amin(-1)
    y1 = torch.where(rows, ar_h, -1).amax(-1)
    x0 = torch.where(cols, ar_w, w).amin(-1)
    x1 = torch.where(cols, ar_w, -1).amax(-1)
    box = torch.stack([x0, y0, x1 - x0 + 1, y1 - y0 + 1], dim=-1)
    return torch.where(rows.any(-1)[..., None], box, 0)


class TorchSamMaskGenerator:
    """Automatic mask generator over a point grid, returning the langsplat
    fork's 4-tuple (default, s, m, l) of mask-dict lists (reference
    preprocess.py:296-329), JAX's `JaxSamMaskGenerator` on the device."""

    def __init__(self, model: Sam | None = None, cfg: SamConfig = VIT_H, *,
                 checkpoint: str | None = None, device=None,
                 points_per_side: int = 32,
                 points_per_batch: int = 64,
                 pred_iou_thresh: float = 0.7,
                 stability_score_thresh: float = 0.85,
                 stability_score_offset: float = 1.0,
                 box_nms_thresh: float = 0.7,
                 min_mask_region_area: int = 100):
        self.device = resolve_device(device)
        if model is None:
            if checkpoint is None:
                raise ValueError("TorchSamMaskGenerator needs a model or a "
                                 "checkpoint path")
            model = Sam.from_checkpoint(checkpoint, cfg, self.device)
        self.model = model.to(self.device).eval()
        self.cfg = model.cfg
        self.points_per_side = points_per_side
        self.points_per_batch = points_per_batch
        self.pred_iou_thresh = pred_iou_thresh
        self.stability_score_thresh = stability_score_thresh
        self.stability_score_offset = stability_score_offset
        self.box_nms_thresh = box_nms_thresh
        self.min_mask_region_area = min_mask_region_area

    def _preprocess(self, image: np.ndarray):
        h, w = image.shape[:2]
        s = self.cfg.img_size
        scale = s / max(h, w)
        nh, nw = round(h * scale), round(w * scale)
        resized = resize_linear_u8(torch.tensor(image, device=self.device),
                                   nw, nh)
        mean = torch.as_tensor(PIXEL_MEAN, device=self.device)
        std = torch.as_tensor(PIXEL_STD, device=self.device)
        x = (resized.float() - mean) / std
        return F.pad(x, (0, 0, 0, s - nw, 0, s - nh)), (nh, nw)

    def points(self, nh: int, nw: int) -> np.ndarray:
        """The 'xy' grid over the valid region, in model-input [0, 1]."""
        n = self.points_per_side
        gx = (np.arange(n) + 0.5) / n
        pts = np.stack(np.meshgrid(gx, gx, indexing="xy"), -1).reshape(-1, 2)
        return pts * np.array([nw / self.cfg.img_size,
                               nh / self.cfg.img_size], np.float32)

    @torch.no_grad()
    def _mask_data(self, image: np.ndarray):
        h, w = image.shape[:2]
        x, (nh, nw) = self._preprocess(image)
        embed = self.model.encode_image(x)
        pts = self.points(nh, nw)
        thr = self.cfg.mask_threshold
        off = self.stability_score_offset
        per = {0: [], 1: [], 2: [], 3: []}    # mask-token index -> entries
        for s0 in range(0, len(pts), self.points_per_batch):
            batch = torch.as_tensor(pts[s0:s0 + self.points_per_batch],
                                    dtype=torch.float32,
                                    device=self.device)[:, None, :]
            labels = torch.ones((batch.shape[0], 1), device=self.device)
            logits, iou = self.model.decode_masks(embed, batch, labels)
            # upscale model-resolution logits to the original image
            full = logits[:, :, :logits.shape[2] * nh // self.cfg.img_size,
                          :logits.shape[3] * nw // self.cfg.img_size]
            lg = resize_linear_f32(full.contiguous(), w, h)
            seg = lg > thr
            counts = torch.stack([
                seg.sum(dim=(-2, -1)), (lg > thr + off).sum(dim=(-2, -1)),
                (lg > thr - off).sum(dim=(-2, -1))], dim=-1)
            boxes = boxes_from_masks(seg)
            counts, boxes = counts.cpu().numpy(), boxes.cpu().numpy()
            iou = iou.float().cpu().numpy()
            del lg
            for b in range(seg.shape[0]):
                best = int(np.argmax(iou[b]))
                for tok in range(seg.shape[1]):
                    area, hi, lo = (int(v) for v in counts[b, tok])
                    if area < self.min_mask_region_area:
                        continue
                    if iou[b, tok] < self.pred_iou_thresh:
                        continue
                    stability = float(hi) / max(float(lo), 1.0)
                    if stability < self.stability_score_thresh:
                        continue
                    per[tok].append({
                        "segmentation": seg[b, tok],
                        "bbox": [int(v) for v in boxes[b, tok]],
                        "predicted_iou": float(iou[b, tok]),
                        "stability_score": stability,
                        "_best": tok == best,
                    })
        return per

    def _nms(self, entries: list[dict]) -> list[dict]:
        if not entries:
            return []
        boxes = np.array([e["bbox"] for e in entries], np.float32)
        scores = np.array([e["predicted_iou"] for e in entries], np.float32)
        keep = _box_nms(boxes, scores, self.box_nms_thresh)
        segs = torch.stack([entries[i]["segmentation"] for i in keep])
        segs = segs.cpu().numpy()
        out = []
        for i, seg in zip(keep, segs):
            e = dict(entries[i], segmentation=seg)
            e.pop("_best", None)
            out.append(e)
        return out

    def generate(self, image: np.ndarray, stats: dict | None = None):
        """`stats`, when given, gets the candidates a level before NMS."""
        per = self._mask_data(image)
        # multimask tokens 1..3 are SAM's subpart/part/whole granularities
        # -> the fork's s / m / l levels; "default" pools each prompt's
        # best-IoU mask (the single-mask selection rule).
        default = [e for tok in per.values() for e in tok if e.get("_best")]
        if stats is not None:
            stats["candidates"] = [len(default)] + [len(per[t])
                                                    for t in (1, 2, 3)]
        return (self._nms(default), self._nms(per[1]),
                self._nms(per[2]), self._nms(per[3]))

    __call__ = generate
