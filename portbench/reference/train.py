"""The feature phase's first steps, from the published method
(LangSplatV2 train.py with --cos_loss --topk 4): each Gaussian's top-k
codebook coefficients (a softmax over its k largest logits), blended to a
K-channel map, decoded through the codebook and held by cosine against
its segment's CLIP row (1 - the sum over labelled pixels / all pixels),
then Adam on the logits and the codebook.

Plain PyTorch. Autograd differentiates the loss and the top-k softmax; the
blend's backward is written out (each entry's row of W^T dL/dmap, read at
its Gaussian's codes), since the blend weights do not depend on the
trained values."""
from __future__ import annotations

import torch

from .precision import matmul
from .render import blend, blend_backward, entries, image_to_tiles, project

LEAVES = ("language_logits", "codebooks")


def topk_codes(logits: torch.Tensor, k: int):
    """Indices [N, k] of each row's k largest logits, ascending."""
    return torch.sort(torch.topk(logits, k, dim=1).indices, dim=1).values


def cos_loss(feat_tiles, books, table, seg_tiles, hw: int, prec: str,
             fault: str | None = None, eps: float = 1e-8):
    """1 - sum over labelled pixels of cos(decoded feature, GT row) / hw.
    feat_tiles [T, 256, K], books [1, K, D], table [S, D], seg_tiles
    [T, 256] (-1: unlabelled or past the image). fault "half_batch" keeps
    only the first half of the tiles' pixels and divides by half of hw."""
    t = feat_tiles.shape[0]
    w = feat_tiles.reshape(t * 256, -1)
    seg = seg_tiles.reshape(-1).long()
    if fault == "half_batch":
        half = (t // 2) * 256
        w, seg, hw = w[:half], seg[:half], hw / 2
    feat = matmul(w, books[0], prec)
    valid = seg >= 0
    gt = torch.where(valid[:, None], table[seg.clamp(min=0)], 0.0)
    num = (feat * gt).sum(-1)
    den = (torch.clamp(torch.linalg.norm(feat, dim=-1), min=eps)
           * torch.clamp(torch.linalg.norm(gt, dim=-1), min=eps))
    return 1.0 - torch.where(valid, num / den, 0.0).sum() / hw


def feature_steps(act: dict, logits0, books0, steps: list, cfg: dict,
                  prec: str = "f32", fault: str | None = None) -> dict:
    """Run len(steps) steps from (logits0, books0). steps: dicts with the
    camera `cam`, the GT `table` [S, D] and `segments` [H, W]. Returns each
    step's loss, the first step's gradient by leaf, and each leaf's change
    after the last step. fault "unchanged": no update is applied."""
    k, K = cfg["topk"], cfg["codebook_size"]
    lr, (b1, b2), eps = (cfg["language_feature_lr"], cfg["adam_betas"],
                         cfg["adam_eps"])
    params = {"language_logits": logits0.clone(), "codebooks": books0.clone()}
    moments = {n: (torch.zeros_like(p), torch.zeros_like(p))
               for n, p in params.items()}
    losses, first = [], None
    for t, st in enumerate(steps, 1):
        cam = st["cam"]
        with torch.no_grad():
            pr = project(act, cam, cfg["sh_degree"])
            ent = entries(pr)
        gx, gy = pr["grid"]
        idx = topk_codes(params["language_logits"], k)
        lg = params["language_logits"].detach().requires_grad_(True)
        pairs = torch.softmax(torch.gather(lg, 1, idx), dim=1)
        with torch.no_grad():
            fmap = blend(pr, ent, pairs.detach(), idx, K, prec)["feat"]
        fmap.requires_grad_(True)
        cb = params["codebooks"].detach().requires_grad_(True)
        seg_t = image_to_tiles(st["segments"], gx, gy, fill=-1)
        loss = cos_loss(fmap, cb, st["table"], seg_t,
                        cam["width"] * cam["height"], prec, fault)
        d_map, d_cb = torch.autograd.grad(loss, [fmap, cb])
        with torch.no_grad():
            d_pairs = blend_backward(pr, ent, idx, d_map, prec)
        (d_lg,) = torch.autograd.grad(pairs, lg, d_pairs)
        grads = {"language_logits": d_lg, "codebooks": d_cb}
        losses.append(float(loss.detach()))
        if first is None:
            first = {n: g.clone() for n, g in grads.items()}
        if fault == "unchanged":
            continue
        with torch.no_grad():
            for n, p in params.items():
                m, v = moments[n]
                g = grads[n]
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v.sqrt() / (1 - b2 ** t) ** 0.5).add_(eps)
                p.addcdiv_(m, denom, value=-lr / (1 - b1 ** t))
    return dict(losses=losses, first_grad=first,
                change={n: params[n] - p0 for n, p0 in
                        (("language_logits", logits0),
                         ("codebooks", books0))})
