"""The Gaussian scene model as an nn.Module
(port of langsplatv2_tpu/models/gaussians.py).

Same raw fields as the JAX pytree (xyz, SH features, log-scale, quaternion,
logit opacity, `live` mask, language logits, codebooks, quick weights and
indices, densification statistics) and the same activations. Quick indices
are integers here; the JAX model carries them as float32. Every raw field
is an nn.Parameter created with requires_grad=False, so serving builds no
autograd graph; each training phase switches its own fields on
(`train/trainer.py::rgb_params`, `feature_params`).

The count of Gaussians is padded to a capacity with a `live` mask, as in the
JAX package, and densify / prune write into free slots. Capacity growth
reallocates every field (`grow_capacity`); the trainer then rebinds the
optimizer to the new tensors. Two in-place departures from the JAX pytree,
which the trainer relies on: `one_up_sh_degree` and
`add_densification_stats` update the model they are given.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .. import tracing
from ..device import resolve_device
from ..ops.knn import mean_sq_dist_3nn
from ..utils import transforms as tf
from ..utils.sh import rgb_to_sh
from ..utils.sparse_codes import (get_weights_and_indices,
                                  softmax_to_topk_soft_code)

PARAM_FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
                "opacity", "language_logits", "codebooks")
BUFFER_FIELDS = ("live", "quick_weights", "quick_indices", "max_radii2d",
                 "xyz_gradient_accum", "denom")


class GaussianModel(nn.Module):
    def __init__(self, *, xyz, features_dc, features_rest, scaling, rotation,
                 opacity, live=None, language_logits=None, codebooks=None,
                 quick_weights=None, quick_indices=None, max_radii2d=None,
                 xyz_gradient_accum=None, denom=None,
                 active_sh_degree: int = 0, max_sh_degree: int = 3,
                 spatial_lr_scale: float = 1.0):
        super().__init__()
        c, dev = xyz.shape[0], xyz.device
        if live is None:
            live = torch.ones(c, dtype=torch.bool, device=dev)
        # The densification statistics always exist, zero when not given.
        if max_radii2d is None:
            max_radii2d = torch.zeros(c, device=dev)
        if xyz_gradient_accum is None:
            xyz_gradient_accum = torch.zeros((c, 1), device=dev)
        if denom is None:
            denom = torch.zeros((c, 1), device=dev)
        values = dict(xyz=xyz, features_dc=features_dc,
                      features_rest=features_rest, scaling=scaling,
                      rotation=rotation, opacity=opacity,
                      language_logits=language_logits, codebooks=codebooks,
                      live=live, quick_weights=quick_weights,
                      quick_indices=quick_indices, max_radii2d=max_radii2d,
                      xyz_gradient_accum=xyz_gradient_accum, denom=denom)
        for name in PARAM_FIELDS:
            v = values[name]
            self.register_parameter(
                name, None if v is None else nn.Parameter(v, requires_grad=False))
        for name in BUFFER_FIELDS:
            self.register_buffer(name, values[name])
        self.active_sh_degree = int(active_sh_degree)
        self.max_sh_degree = int(max_sh_degree)
        self.spatial_lr_scale = float(spatial_lr_scale)

    def fields(self) -> dict:
        return {n: getattr(self, n) for n in PARAM_FIELDS + BUFFER_FIELDS}

    def replace(self, **changes) -> "GaussianModel":
        """A new model sharing every tensor not named in `changes`."""
        kw = self.fields()
        kw.update(active_sh_degree=self.active_sh_degree,
                  max_sh_degree=self.max_sh_degree,
                  spatial_lr_scale=self.spatial_lr_scale)
        kw.update(changes)
        kw = {k: (v.detach() if isinstance(v, nn.Parameter) else v)
              for k, v in kw.items()}
        return GaussianModel(**kw)

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    @property
    def num_live(self) -> torch.Tensor:
        return self.live.sum()

    def one_up_sh_degree(self) -> "GaussianModel":
        """Raise the active SH degree by one, up to the maximum, in place."""
        if self.active_sh_degree < self.max_sh_degree:
            self.active_sh_degree += 1
        return self

    def get_scaling(self):
        return tf.scaling_activation(self.scaling)

    def get_rotation(self):
        return tf.rotation_activation(self.rotation)

    def get_opacity(self):
        """Activated opacity, 0 on dead (padding) rows."""
        return torch.where(self.live[:, None],
                           tf.opacity_activation(self.opacity), 0.0)

    def get_features(self):
        return torch.cat([self.features_dc, self.features_rest], dim=1)

    def get_covariance(self, scaling_modifier: float = 1.0):
        """[N, 6] world covariances (xx xy xz yy yz zz) of the scaled
        Gaussians, as the reference's build_covariance_from_scaling_rotation
        gives them."""
        return tf.covariance_from_scaling_rotation(
            self.get_scaling(), scaling_modifier, self.rotation)

    def get_render_weights(self, k: int):
        """Per-layer softmax -> top-k coefficients, concatenated to
        [C, L*K] f32 (the dense feature-phase field), differentiable in
        the logits."""
        L, K, _ = self.codebooks.shape
        return torch.cat([
            softmax_to_topk_soft_code(
                self.language_logits[:, i * K:(i + 1) * K], k)
            for i in range(L)], dim=-1).float()

    def get_weights_and_indices(self, k: int):
        """Per-layer top-k (weights, indices), each [C, L*k], indices
        offset by layer*K (csrc/topk_codes.cu on the card, one launch for
        every layer); in the span "topk_codes"."""
        with tracing.span("topk_codes"):
            return get_weights_and_indices(self.language_logits, k,
                                           levels=self.codebooks.shape[0])

    def compute_layer_feature_map(self, weight_map: torch.Tensor,
                                  layer_idx: int):
        """Residual decode up to `layer_idx` of a [L*K, H, W] map ->
        [512, H, W]; earlier layers enter detached (the training
        curriculum)."""
        L, K, D = self.codebooks.shape
        _, H, W = weight_map.shape
        flat = weight_map.reshape(L * K, H * W)
        feat = None
        for i in range(int(layer_idx) + 1):
            layer = torch.einsum("kd,kp->dp", self.codebooks[i],
                                 flat[i * K:(i + 1) * K])
            if feat is not None:
                layer = layer + feat.detach()
            feat = layer
        return feat.reshape(D, H, W)

    def compute_final_feature_map(self, weight_map: torch.Tensor):
        """[L*K, H, W] coefficient map -> [512, H, W] decoded feature map."""
        L, K, D = self.codebooks.shape
        _, H, W = weight_map.shape
        flat = weight_map.reshape(L * K, H * W)
        return torch.einsum("kd,kp->dp", self.codebooks.reshape(L * K, D),
                            flat).reshape(D, H, W)


def _pad(x: torch.Tensor, capacity: int) -> torch.Tensor:
    n = x.shape[0]
    if n == capacity:
        return x
    return torch.cat([x, x.new_zeros((capacity - n,) + tuple(x.shape[1:]))])


def _pad_rotation(q: torch.Tensor, capacity: int) -> torch.Tensor:
    """Pad quaternions with the identity: a zero quaternion would normalize
    to NaN."""
    n = q.shape[0]
    out = _pad(q, capacity)
    if capacity > n:
        out[n:, 0] = 1.0
    return out


def create_from_pcd(points, colors, spatial_lr_scale: float,
                    max_sh_degree: int = 3, capacity: int | None = None,
                    knn_mean_sq_dist=None, device=None) -> GaussianModel:
    """Initialize from a point cloud (reference gaussian_model.py:184-210):
    scales from the mean squared distance to the 3 nearest neighbours,
    identity rotation, opacity 0.1, SH degree 0 active."""
    dev = resolve_device(device)
    pts = torch.tensor(np.asarray(points, np.float32), device=dev)
    n = pts.shape[0]
    capacity = capacity or n
    if capacity < n:
        raise ValueError(f"capacity {capacity} < {n} points")
    if knn_mean_sq_dist is None:
        dist2 = mean_sq_dist_3nn(pts)
    else:
        dist2 = torch.tensor(np.asarray(knn_mean_sq_dist, np.float32),
                             device=dev)
    dist2 = torch.clamp(dist2, min=1e-7)
    scales = torch.log(torch.sqrt(dist2))[:, None].repeat(1, 3)
    ncoef = (max_sh_degree + 1) ** 2
    cols = torch.tensor(np.asarray(colors, np.float32), device=dev)
    rots = torch.zeros((n, 4), device=dev)
    rots[:, 0] = 1.0
    live = torch.zeros(capacity, dtype=torch.bool, device=dev)
    live[:n] = True
    return GaussianModel(
        xyz=_pad(pts, capacity),
        features_dc=_pad(rgb_to_sh(cols)[:, None, :], capacity),
        features_rest=torch.zeros((capacity, ncoef - 1, 3), device=dev),
        scaling=_pad(scales, capacity),
        rotation=_pad_rotation(rots, capacity),
        opacity=_pad(tf.inverse_sigmoid(0.1 * torch.ones((n, 1), device=dev)),
                     capacity),
        live=live, active_sh_degree=0, max_sh_degree=max_sh_degree,
        spatial_lr_scale=spatial_lr_scale)


def init_language_features(model: GaussianModel, vq_layer_num: int,
                           codebook_size: int, clip_dim: int = 512, *,
                           generator: torch.Generator | None = None,
                           logits=None, codebooks=None) -> GaussianModel:
    """Attach language logits [N, L*K] and codebooks [L, K, clip_dim]:
    standard normal draws from `generator` (on its device, then moved to
    the model's), or the given arrays (so that a test can hand both
    packages the same values; the JAX version draws from a jax key)."""
    dev = model.xyz.device
    shapes = {"logits": (model.capacity, vq_layer_num * codebook_size),
              "codebooks": (vq_layer_num, codebook_size, clip_dim)}
    given = {"logits": logits, "codebooks": codebooks}
    out = {}
    for name, shape in shapes.items():
        v = given[name]
        if v is None:
            if generator is None:
                raise ValueError(f"init_language_features: no {name} and no "
                                 "generator to draw them from")
            v = torch.randn(shape, generator=generator,
                            device=generator.device)
        v = torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v,
                            dtype=torch.float32)
        if tuple(v.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(v.shape)}, expected "
                             f"{shape}")
        out[name] = v.to(dev)
    return model.replace(language_logits=out["logits"],
                         codebooks=out["codebooks"])


def _exact_indices(a: np.ndarray) -> np.ndarray:
    """Float codebook indices (the JAX model's dtype) -> int32, exactly."""
    if np.issubdtype(a.dtype, np.floating):
        r = np.rint(a)
        if not np.array_equal(r, a):
            raise ValueError("quick_indices hold non-integer values")
        a = r
    return a.astype(np.int32)


def from_numpy_params(fields: dict, *, active_sh_degree: int | None = None,
                      max_sh_degree: int | None = None,
                      spatial_lr_scale: float = 1.0,
                      device=None) -> GaussianModel:
    """Build the port's model from the JAX GaussianModel fields as numpy
    arrays (the names of langsplatv2_tpu/models/io.py MODEL_FIELDS; missing
    language fields stay None, missing densification statistics are zero,
    a missing `live` means all rows live)."""
    dev = resolve_device(device)
    kw = {}
    for name in PARAM_FIELDS + BUFFER_FIELDS:
        v = fields.get(name)
        if v is None:
            continue
        v = np.asarray(v)
        if name == "quick_indices":
            v = _exact_indices(v)
        elif name == "live":
            v = v.astype(bool)
        else:
            v = v.astype(np.float32)
        kw[name] = torch.from_numpy(np.ascontiguousarray(v)).to(dev)
    qi, books = kw.get("quick_indices"), kw.get("codebooks")
    if qi is not None and qi.numel():
        n_ch = (books.shape[0] * books.shape[1] if books is not None
                else None)
        lo, hi = int(qi.min()), int(qi.max())
        if lo < 0 or (n_ch is not None and hi >= n_ch):
            raise ValueError(
                f"quick_indices span [{lo}, {hi}], outside [0, {n_ch})")
    if max_sh_degree is None:
        n_rest = kw["features_rest"].shape[1]
        max_sh_degree = int(round((n_rest + 1) ** 0.5)) - 1
    if active_sh_degree is None:
        active_sh_degree = max_sh_degree
    return GaussianModel(**kw, active_sh_degree=active_sh_degree,
                         max_sh_degree=max_sh_degree,
                         spatial_lr_scale=spatial_lr_scale)


# ------------------------------------------------------------ densification

@torch.no_grad()
def add_densification_stats(model: GaussianModel, means2d_grad,
                            update_filter) -> None:
    """Accumulate the screen-space positional gradient norm of the visible
    Gaussians, in place (reference gaussian_model.py:505-508)."""
    norm = torch.linalg.norm(means2d_grad[:, :2], dim=-1, keepdim=True)
    upd = update_filter[:, None]
    model.xyz_gradient_accum += torch.where(upd, norm, 0.0)
    model.denom += upd.to(model.denom.dtype)


@torch.no_grad()
def densify_and_prune(model: GaussianModel, eps: torch.Tensor,
                      max_grad: float, min_opacity: float, extent: float,
                      max_screen_size: float, percent_dense: float,
                      n_split: int = 2):
    """One densification round (reference gaussian_model.py:448-503), as
    the JAX package does it on a padded capacity:

    - clone: small Gaussians (max scale <= percent_dense * extent) whose
      mean screen-space gradient reaches max_grad are duplicated;
    - split: large ones are replaced by n_split samples from their own
      ellipsoid, `eps` [n_split, C, 3] standard normal draws (the JAX
      version draws them from a jax key; the caller draws them here),
      scales shrunk by 1 / (0.8 n_split);
    - prune: opacity < min_opacity, or, when max_screen_size > 0, world
      scale > 0.1 extent (the reference's screen-radius prune can never
      fire and is left out, as in JAX); children that would be pruned at
      once are never placed.

    Candidates are ordered (clones, split copy 0, split copy 1, ...); the
    r-th kept one goes to the r-th free slot. Returns (model, overflow []
    int, placed [C] bool): overflow > 0 means the capacity was too small
    and the excess children were dropped; `placed` marks the slots that
    received a new Gaussian. The statistics are reset."""
    C = model.capacity
    dev = model.xyz.device
    denom = model.denom[:, 0]
    grads = torch.where(denom > 0, model.xyz_gradient_accum[:, 0]
                        / torch.clamp(denom, min=1.0), 0.0)
    scaling = model.get_scaling()
    max_scale = scaling.max(dim=1).values
    opacity = tf.opacity_activation(model.opacity[:, 0])
    live = model.live

    hot = live & (grads >= max_grad)
    clone_mask = hot & (max_scale <= percent_dense * extent)
    split_mask = hot & (max_scale > percent_dense * extent)
    prune = live & (opacity < min_opacity)
    if max_screen_size > 0:
        prune = prune | (live & (max_scale > 0.1 * extent))
    prune = prune | split_mask
    live_after_prune = live & ~prune

    child_max_scale = max_scale / (0.8 * n_split)
    ws_ok_split = (child_max_scale <= 0.1 * extent) if max_screen_size > 0 \
        else torch.ones_like(live)
    clone_keep = clone_mask & (opacity >= min_opacity)
    split_keep = split_mask & (opacity >= min_opacity) & ws_ok_split

    R = tf.quat_to_rotmat(model.rotation)                      # [C, 3, 3]
    v = eps * scaling[None]                                    # [n, C, 3]
    samples = (R[None, :, :, 0] * v[..., 0:1] + R[None, :, :, 1] * v[..., 1:2]
               + R[None, :, :, 2] * v[..., 2:3])
    split_xyz = model.xyz[None] + samples
    split_scaling = torch.log(torch.clamp(scaling / (0.8 * n_split),
                                          min=1e-30))

    wants = torch.cat([clone_keep] + [split_keep] * n_split).long()
    want_rank = torch.cumsum(wants, 0) - wants
    free = ~live_after_prune
    n_free = free.sum()
    overflow = torch.clamp(wants.sum() - n_free, min=0)
    slot_of_rank = torch.full((C,), C, dtype=torch.long, device=dev)
    free_slots = torch.nonzero(free)[:, 0]
    slot_of_rank[:free_slots.shape[0]] = free_slots
    fits = (wants > 0) & (want_rank < n_free)
    dest = slot_of_rank[torch.clamp(want_rank, 0, C - 1)][fits]

    def place(field, clone_rows, split_rows):
        rows = torch.cat([clone_rows[None], split_rows]).reshape(
            ((1 + n_split) * C,) + tuple(clone_rows.shape[1:]))
        out = field.detach().clone()
        out[dest] = rows[fits]
        return out

    def bcast(x):
        return x.detach()[None].expand((n_split,) + tuple(x.shape))

    new_live = live_after_prune.clone()
    new_live[dest] = True
    placed = torch.zeros(C, dtype=torch.bool, device=dev)
    placed[dest] = True
    new_model = model.replace(
        xyz=place(model.xyz, model.xyz.detach(), split_xyz),
        scaling=place(model.scaling, model.scaling.detach(),
                      bcast(split_scaling)),
        features_dc=place(model.features_dc, model.features_dc.detach(),
                          bcast(model.features_dc)),
        features_rest=place(model.features_rest, model.features_rest.detach(),
                            bcast(model.features_rest)),
        opacity=place(model.opacity, model.opacity.detach(),
                      bcast(model.opacity)),
        rotation=place(model.rotation, model.rotation.detach(),
                       bcast(model.rotation)),
        live=new_live,
        xyz_gradient_accum=torch.zeros_like(model.xyz_gradient_accum),
        denom=torch.zeros_like(model.denom),
        max_radii2d=torch.zeros_like(model.max_radii2d))
    return new_model, overflow, placed


@torch.no_grad()
def reset_opacity(model: GaussianModel) -> GaussianModel:
    """Clamp the activated opacity to <= 0.01 (reference
    gaussian_model.py:308-311)."""
    return model.replace(opacity=tf.inverse_sigmoid(torch.clamp(
        tf.opacity_activation(model.opacity), max=0.01)))


@torch.no_grad()
def grow_capacity(model: GaussianModel, new_capacity: int) -> GaussianModel:
    """Reallocate every per-Gaussian field at `new_capacity` rows: new rows
    are dead, zero, with identity rotations."""
    if new_capacity < model.capacity:
        raise ValueError(f"cannot shrink {model.capacity} to {new_capacity}")
    changes = {}
    for name, v in model.fields().items():
        if v is None or name == "codebooks":
            continue
        pad = _pad_rotation if name == "rotation" else _pad
        changes[name] = pad(v.detach(), new_capacity)
    return model.replace(**changes)


@torch.no_grad()
def compact(model: GaussianModel) -> GaussianModel:
    """Drop the padding, keeping live rows only (for export)."""
    idx = torch.nonzero(model.live)[:, 0]
    changes = {name: v.detach()[idx] for name, v in model.fields().items()
               if v is not None and name != "codebooks"}
    return model.replace(**changes)
