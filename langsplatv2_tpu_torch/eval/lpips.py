"""LPIPS perceptual distance (port of langsplatv2_tpu/eval/lpips.py; the
reference vendors lpipsPyTorch/, imported nowhere in its tree).

The VGG16 and AlexNet feature trunks are `torch.nn` modules built here
(torchvision is not a dependency), with the LPIPS linear heads as buffers.
Parameters travel as the JAX module's pytree of numpy arrays:
{"convs": [(w [O, I, k, k], b [O]), ...], "heads": [[C], ...]}.
`random_params` draws JAX's random instance with the same numpy calls,
`load_torch_state_dict` converts torchvision trunk weights plus the LPIPS
heads, and `LPIPS(params, net)` carries either into the modules. Set
torch.backends.cudnn.allow_tf32 = False on the card for f32 convolutions.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device

# (out_channels, kernel, stride[, padding]) a conv layer, ("pool",) a max
# pool; LPIPS taps the ReLU outputs listed in _TAPS.
_VGG16_CFG = [
    (64, 3, 1), (64, 3, 1), ("pool",), (128, 3, 1), (128, 3, 1), ("pool",),
    (256, 3, 1), (256, 3, 1), (256, 3, 1), ("pool",),
    (512, 3, 1), (512, 3, 1), (512, 3, 1), ("pool",),
    (512, 3, 1), (512, 3, 1), (512, 3, 1),
]
_VGG16_TAPS = [1, 3, 6, 9, 12]          # relu1_2, 2_2, 3_3, 4_3, 5_3
_VGG16_TAP_CH = [64, 128, 256, 512, 512]
_ALEX_CFG = [
    (64, 11, 4, 2), ("pool",), (192, 5, 1, 2), ("pool",),
    (384, 3, 1, 1), (256, 3, 1, 1), (256, 3, 1, 1),
]
_ALEX_TAPS = [0, 1, 2, 3, 4]
_ALEX_TAP_CH = [64, 192, 384, 256, 256]
_CFG = {"vgg": (_VGG16_CFG, _VGG16_TAPS, _VGG16_TAP_CH, 2),
        "alex": (_ALEX_CFG, _ALEX_TAPS, _ALEX_TAP_CH, 3)}

# lpips' scaling layer (ImageNet shift / scale in [-1, 1] units).
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def _net_cfg(net: str):
    if net not in _CFG:
        raise ValueError(f"LPIPS net must be 'vgg' or 'alex', not {net!r}")
    return _CFG[net]


class LPIPS(nn.Module):
    """The trunk of `net` ("vgg" or "alex") with its LPIPS heads, from a
    parameter pytree (numpy or torch arrays)."""

    def __init__(self, params: dict, net: str = "vgg"):
        super().__init__()
        cfg, self.taps, tap_ch, self.pool_k = _net_cfg(net)
        self.layers = list(cfg)
        convs = []
        for (w, b), layer in zip(params["convs"],
                                 [c for c in cfg if c[0] != "pool"]):
            w = torch.as_tensor(np.asarray(w), dtype=torch.float32)
            conv = nn.Conv2d(w.shape[1], w.shape[0], w.shape[2],
                             stride=layer[2],
                             padding=layer[3] if len(layer) > 3 else 1)
            with torch.no_grad():
                conv.weight.copy_(w)
                conv.bias.copy_(torch.as_tensor(np.asarray(b)))
            convs.append(conv)
        self.convs = nn.ModuleList(convs)
        for i, (h, c) in enumerate(zip(params["heads"], tap_ch)):
            head = torch.as_tensor(np.asarray(h), dtype=torch.float32)
            if head.shape != (c,):
                raise ValueError(f"head {i}: shape {tuple(head.shape)}, "
                                 f"expected ({c},)")
            self.register_buffer(f"head{i}", head)
        self.register_buffer("shift", torch.from_numpy(_SHIFT)[None, :, None,
                                                               None])
        self.register_buffer("scale", torch.from_numpy(_SCALE)[None, :, None,
                                                               None])

    def features(self, x: torch.Tensor) -> list[torch.Tensor]:
        """The tapped ReLU outputs of the trunk on [N, 3, H, W]."""
        feats, relu_i, convs = [], 0, iter(self.convs)
        for layer in self.layers:
            if layer[0] == "pool":
                x = F.max_pool2d(x, self.pool_k, 2)
                continue
            x = F.relu(next(convs)(x))
            if relu_i in self.taps:
                feats.append(x)
            relu_i += 1
        return feats

    def forward(self, img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
        """LPIPS distance [N] between [N, 3, H, W] images in [0, 1]: scaled
        to [-1, 1], normalized, unit-normalized per-tap feature
        differences, 1x1 linear heads, spatial mean, summed over taps."""
        def prep(x):
            return (2.0 * x - 1.0 - self.shift) / self.scale

        def unit(x, eps=1e-10):
            return x * torch.rsqrt((x * x).sum(dim=1, keepdim=True) + eps)

        total = 0.0
        for i, (a, b) in enumerate(zip(self.features(prep(img0)),
                                       self.features(prep(img1)))):
            d = (unit(a) - unit(b)) ** 2
            head = getattr(self, f"head{i}")
            total = total + (d * head[None, :, None, None]).sum(dim=1).mean(
                dim=(1, 2))
        return total


def lpips(params: dict, img0, img1, net: str = "vgg", *,
          device=None) -> torch.Tensor:
    """LPIPS distance [N] between [N, 3, H, W] images in [0, 1] (JAX's
    `lpips(params, img0, img1, net)`), on `device` (CUDA unless "cpu")."""
    dev = resolve_device(device)
    model = LPIPS(params, net).to(dev)
    with torch.no_grad():
        return model(torch.as_tensor(img0, dtype=torch.float32, device=dev),
                     torch.as_tensor(img1, dtype=torch.float32, device=dev))


def random_params(net: str = "vgg", seed: int = 0) -> dict:
    """JAX's deterministic random-weight instance, the same numpy draws."""
    cfg, _, taps, _ = _net_cfg(net)
    rng = np.random.default_rng(seed)
    convs = []
    cin = 3
    for layer in cfg:
        if layer[0] == "pool":
            continue
        cout, k = layer[0], layer[1]
        w = (rng.normal(size=(cout, cin, k, k)) / np.sqrt(cin * k * k)
             ).astype(np.float32)
        convs.append((w, np.zeros(cout, np.float32)))
        cin = cout
    heads = [np.abs(rng.normal(size=c)).astype(np.float32) / c for c in taps]
    return {"convs": convs, "heads": heads}


def load_torch_state_dict(trunk_state: dict, heads_state: dict,
                          net: str = "vgg") -> dict:
    """torchvision trunk weights (`vgg16(...).features` /
    `alexnet(...).features` state dict) and the LPIPS heads
    (`lins.{i}.model.1.weight`) -> the parameter pytree."""
    def to_np(t):
        return np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach")
                          else t)

    idx = sorted({int(k.split(".")[0]) for k in trunk_state
                  if k.endswith(".weight")})
    convs = [(to_np(trunk_state[f"{i}.weight"]),
              to_np(trunk_state[f"{i}.bias"])) for i in idx]
    heads = []
    for i in range(len(_net_cfg(net)[1])):
        for key in (f"lins.{i}.model.1.weight", f"lin{i}.model.1.weight"):
            if key in heads_state:
                heads.append(to_np(heads_state[key])[:, :, 0, 0][0])
                break
        else:
            raise KeyError(f"missing LPIPS head {i}")
    return {"convs": convs, "heads": heads}
