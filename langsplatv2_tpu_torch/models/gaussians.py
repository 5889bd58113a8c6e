"""The Gaussian scene model as an nn.Module
(port of langsplatv2_tpu/models/gaussians.py:50-158, 210-224).

Same raw fields as the JAX pytree (xyz, SH features, log-scale, quaternion,
logit opacity, `live` mask, language logits, codebooks, quick weights and
indices) and the same activations. Quick indices are integers here; the
JAX model carries them as float32. Every raw field is an nn.Parameter
created with requires_grad=False, so serving builds no autograd graph; the
feature phase switches the language logits and codebooks on
(`train/trainer.py::feature_params`). Densify/prune belong to the geometry
training slice.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..utils import transforms as tf
from ..utils.sparse_codes import get_weights_and_indices

PARAM_FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
                "opacity", "language_logits", "codebooks")
BUFFER_FIELDS = ("live", "quick_weights", "quick_indices")


class GaussianModel(nn.Module):
    def __init__(self, *, xyz, features_dc, features_rest, scaling, rotation,
                 opacity, live=None, language_logits=None, codebooks=None,
                 quick_weights=None, quick_indices=None,
                 active_sh_degree: int = 0, max_sh_degree: int = 3,
                 spatial_lr_scale: float = 1.0):
        super().__init__()
        if live is None:
            live = torch.ones(xyz.shape[0], dtype=torch.bool,
                              device=xyz.device)
        values = dict(xyz=xyz, features_dc=features_dc,
                      features_rest=features_rest, scaling=scaling,
                      rotation=rotation, opacity=opacity,
                      language_logits=language_logits, codebooks=codebooks,
                      live=live, quick_weights=quick_weights,
                      quick_indices=quick_indices)
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

    def get_weights_and_indices(self, k: int):
        """Per-layer top-k (weights, indices), each [C, L*k], indices
        offset by layer*K."""
        L, K, _ = self.codebooks.shape
        ws, idxs = [], []
        for i in range(L):
            w, idx = get_weights_and_indices(
                self.language_logits[:, i * K:(i + 1) * K], k)
            ws.append(w)
            idxs.append(idx + i * K)
        return torch.cat(ws, dim=-1), torch.cat(idxs, dim=-1)

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
    optional fields stay None, a missing `live` means all rows live)."""
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
