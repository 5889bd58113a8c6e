"""Sparse top-k codes over the codebook
(port of langsplatv2_tpu/utils/sparse_codes.py:17-99).

Top-k keeps `_topk_onehots`' order: value descending, lowest index first on
ties. The selection carries no gradient; `get_weights_and_indices`'
weights are a softmax over the gathered selected logits, so autograd gives
logits that were not selected exactly zero gradient (the JAX docstring's
contract, :63-72).

The residual k-means codebook init (:100-187, reference vq_utils.py:56-70)
draws from a torch.Generator where JAX draws from jax.random, so its
centres are not JAX's under one seed; the k-means++ centres and the
mini-batch indices can be handed in instead of drawn, which is how the
tests hold it to JAX.
"""
from __future__ import annotations

import numpy as np
import torch


def _topk_columns(y: torch.Tensor, k: int) -> list[torch.Tensor]:
    """Indices [N] of the k largest entries of each row of y [N, K], by
    iterative masked max with the lowest index winning a tie."""
    K = y.shape[1]
    iota = torch.arange(K, device=y.device)
    ym = y.detach().clone()
    cols = []
    for _ in range(k):
        is_max = ym == ym.max(dim=1, keepdim=True).values
        cmin = torch.where(is_max, iota, K).min(dim=1).values
        cols.append(cmin)
        ym.scatter_(1, cmin[:, None], float("-inf"))
    return cols


def softmax_to_topk_soft_code(logits: torch.Tensor, k: int) -> torch.Tensor:
    """[N, K] logits -> softmax, keep the top-k, renormalize (+1e-10)."""
    y = torch.softmax(logits, dim=1)
    mask = torch.zeros_like(y, dtype=torch.bool)
    for idx in _topk_columns(y, k):
        mask.scatter_(1, idx[:, None], True)
    y_topk = torch.where(mask, y, 0.0)
    return y_topk / (y_topk.sum(dim=1, keepdim=True) + 1e-10)


def get_weights_and_indices(logits: torch.Tensor, k: int):
    """Compact form: ([N, k] f32 weights, [N, k] int64 indices), ordered by
    ascending codebook index; the weights are a softmax over the selected
    logits (selection by raw logits, as the reference's softmax is monotone).

    The JAX version returns float indices; the port keeps them integer."""
    idx = torch.stack(_topk_columns(logits, k), dim=1)
    idx, _ = torch.sort(idx, dim=1)
    weights = torch.softmax(torch.gather(logits, 1, idx), dim=1)
    return weights.float(), idx


# ------------------------------------------------ residual k-means codebooks

def _assign(points: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Nearest centre of each point by |c|^2 - 2 p.c (one matrix product),
    the lowest index on a tie."""
    c2 = (centers ** 2).sum(-1)
    return torch.argmin(c2[None, :] - 2.0 * (points @ centers.T), dim=1)


def kmeans_pp_init(points: torch.Tensor, num_clusters: int,
                   generator: torch.Generator) -> torch.Tensor:
    """k-means++ seeding: the first centre uniform, each next one drawn
    with probability proportional to the squared distance to the nearest
    chosen centre. When every point already is a centre (all distances 0)
    the next one is the last point, as JAX's choice gives."""
    m = points.shape[0]
    gdev = generator.device

    def draw(weights=None) -> int:
        if weights is None:
            return int(torch.randint(0, m, (1,), generator=generator,
                                     device=gdev))
        if not bool(weights.sum() > 0):
            return m - 1
        return int(torch.multinomial(weights.to(gdev), 1,
                                     generator=generator))

    centers = points.new_zeros((num_clusters,) + tuple(points.shape[1:]))
    centers[0] = points[draw()]
    min_d2 = ((points - centers[0]) ** 2).sum(-1)
    for i in range(1, num_clusters):
        centers[i] = points[draw(min_d2)]
        min_d2 = torch.minimum(min_d2, ((points - centers[i]) ** 2).sum(-1))
    return centers


def minibatch_kmeans(points: torch.Tensor, num_clusters: int,
                     iters: int = 50, batch_size: int = 16384, *,
                     generator: torch.Generator | None = None,
                     init_centers=None, batch_indices=None) -> torch.Tensor:
    """Mini-batch k-means (Sculley 2010, sklearn's MiniBatchKMeans in the
    reference): each batch assigns its points to the nearest centre and
    moves each centre toward its batch mean at a per-centre rate
    batch count / running count. Returns the centres [num_clusters, D].

    `init_centers` [num_clusters, D] replaces the k-means++ seeding and
    `batch_indices` [iters, batch_size] the uniform batch draws; what is
    not given is drawn from `generator`."""
    m = points.shape[0]
    dev = points.device
    if (init_centers is None or batch_indices is None) and generator is None:
        raise ValueError("minibatch_kmeans needs a generator for the draws "
                         "it is not given")
    def given(a) -> torch.Tensor:
        return (a if torch.is_tensor(a) else torch.from_numpy(np.array(a))
                ).to(dev)

    centers = (kmeans_pp_init(points, num_clusters, generator)
               if init_centers is None
               else given(init_centers).to(points.dtype).clone())
    counts = torch.zeros(num_clusters, dtype=points.dtype, device=dev)
    for it in range(iters):
        if batch_indices is None:
            bidx = torch.randint(0, m, (batch_size,), generator=generator,
                                 device=generator.device).to(dev)
        else:
            bidx = given(batch_indices[it]).long()
        batch = points[bidx]
        assign = _assign(batch, centers)
        batch_counts = torch.bincount(assign, minlength=num_clusters).to(
            points.dtype)
        batch_sums = torch.zeros_like(centers).index_add_(0, assign, batch)
        counts = counts + batch_counts
        lr = batch_counts / torch.clamp(counts, min=1.0)
        means = batch_sums / torch.clamp(batch_counts, min=1.0)[:, None]
        centers = centers + lr[:, None] * (means - centers)
    return centers


def residual_kmeans_codebooks(features: torch.Tensor, num_levels: int,
                              num_clusters: int, iters: int = 50,
                              batch_size: int = 16384, *,
                              generator: torch.Generator | None = None,
                              init_centers=None,
                              batch_indices=None) -> torch.Tensor:
    """Per-level codebooks fitted on successive quantization residuals.
    Returns [num_levels, num_clusters, D]. `init_centers` and
    `batch_indices`, when given, hold one entry a level (see
    minibatch_kmeans)."""
    residuals = features
    books = []
    for level in range(num_levels):
        centers = minibatch_kmeans(
            residuals, num_clusters, iters, batch_size, generator=generator,
            init_centers=None if init_centers is None
            else init_centers[level],
            batch_indices=None if batch_indices is None
            else batch_indices[level])
        residuals = residuals - centers[_assign(residuals, centers)]
        books.append(centers)
    return torch.stack(books)
