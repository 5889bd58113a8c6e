"""What the harness shares: files found by name, the seeded scene and
cameras.

Nothing here imports the program: the scene and the cameras are the
benchmark's inputs, handed alike to the program and to the reference.
"""
from __future__ import annotations

import importlib.util
import json
import math
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent          # portbench/
REPO = HERE.parent                               # the checkout's root
# Modules that no process of the benchmark may hold (compared by whole
# top-level name: the port's own name begins with the JAX package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "langsplatv2_tpu")
SH_C0 = 0.28209479177387814


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(REPO / "BENCHMARK.json")


def cell(name: str) -> tuple[dict, dict, dict, dict]:
    """(the workload's BENCHMARK.json entry, its configuration, its traffic
    mix, its cell file), each found by the name the entry gives."""
    bench = benchmark()
    for w in bench["workloads"]:
        if w["name"] == name:
            break
    else:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cfg = load_json(HERE / "configs" / f"{w['config']}.json")
    traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    spec = load_json(HERE / "workloads" / f"{name}.json")
    for key in ("config", "traffic"):
        if spec[key] != w[key]:
            raise ValueError(f"{name}: the cell file names {key} "
                             f"{spec[key]!r}, BENCHMARK.json {w[key]!r}")
    return w, cfg, traffic, spec


def load_module(path: Path):
    """A module of the harness's own found by file name (metric readers,
    entries): loaded from its path, since a metric's name holds dots."""
    name = "portbench_dyn_" + "".join(
        c if c.isalnum() else "_" for c in str(path.relative_to(HERE)))
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules(modules=None) -> list[str]:
    """Names in `modules` (default sys.modules) whose top-level name is
    one of FORBIDDEN, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)


def generator(seed: int, device, stream: int = 0) -> torch.Generator:
    """A torch.Generator on `device` from the run's seed (any whole number
    up to 2**64) and a stream number, so that independent draws do not
    share a sequence."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % 2 ** 63)
    return g


# ------------------------------------------------------------ the scene

def make_scene(cfg: dict, seed: int, device) -> dict:
    """bench.py:238-251's recipe on the device from the seed, in a few
    large draws: means uniform in the configured box, scales uniform,
    rotations normal, opacities uniform, colours uniform as SH degree 0
    plus small higher-degree terms. Returns the GaussianModel's raw fields
    (log-scale, logit opacity) in f32."""
    sc = cfg["scene"]
    n, deg = cfg["n_gaussians"], cfg["sh_degree"]
    g = generator(seed, device, 1)
    u = torch.rand((n, 11), generator=g, device=device)
    lo = torch.tensor([sc["xy_range"][0]] * 2 + [sc["z_range"][0]],
                      device=device)
    hi = torch.tensor([sc["xy_range"][1]] * 2 + [sc["z_range"][1]],
                      device=device)
    xyz = lo + (hi - lo) * u[:, 0:3]
    s_lo, s_hi = sc["scale_range"]
    scales = s_lo + (s_hi - s_lo) * u[:, 3:6]
    o_lo, o_hi = sc["opacity_range"]
    op = o_lo + (o_hi - o_lo) * u[:, 6:7]
    colors = u[:, 7:10]
    rotation = torch.randn((n, 4), generator=g, device=device)
    n_rest = (deg + 1) ** 2 - 1
    rest = sc["sh_rest_scale"] * (
        2.0 * torch.rand((n, n_rest, 3), generator=g, device=device) - 1.0)
    return dict(xyz=xyz.contiguous(), scaling=torch.log(scales),
                rotation=rotation, opacity=torch.log(op / (1.0 - op)),
                features_dc=((colors - 0.5) / SH_C0)[:, None, :].contiguous(),
                features_rest=rest)


def quick_codes(cfg: dict, seed: int, device) -> dict:
    """The merged quick model's codes: per level `topk` distinct codebook
    rows (ascending, as a merged model's top-k indices are) with weights
    normalized over all levels' pairs, and normal codebooks [L, K, D]."""
    n, L, K, k = (cfg["n_gaussians"], cfg["levels"], cfg["codebook_size"],
                  cfg["topk"])
    g = generator(seed, device, 2)
    idx = []
    for lvl in range(L):
        r = torch.rand((n, K), generator=g, device=device)
        pick = torch.argsort(r, dim=1)[:, :k]
        idx.append(torch.sort(pick, dim=1).values + lvl * K)
    qw = torch.rand((n, L * k), generator=g, device=device)
    qw = qw / qw.sum(1, keepdim=True)
    books = torch.randn((L, K, cfg["clip_dim"]), generator=g, device=device)
    return dict(quick_weights=qw, quick_indices=torch.cat(idx, 1).int(),
                codebooks=books)


def feature_codes(cfg: dict, seed: int, device) -> dict:
    """The feature phase's trained state at its start, as
    init_language_features draws it: normal logits [N, L*K] and normal
    codebooks [L, K, D]."""
    n, L, K = cfg["n_gaussians"], cfg["levels"], cfg["codebook_size"]
    g = generator(seed, device, 3)
    return dict(
        language_logits=torch.randn((n, L * K), generator=g, device=device),
        codebooks=torch.randn((L, K, cfg["clip_dim"]), generator=g,
                              device=device))


# ------------------------------------------------------------ cameras

def projection_matrix(znear: float, zfar: float, fovx: float,
                      fovy: float) -> np.ndarray:
    """3DGS's getProjectionMatrix (z in [0, 1])."""
    top, right = math.tan(fovy / 2) * znear, math.tan(fovx / 2) * znear
    P = np.zeros((4, 4))
    P[0, 0], P[1, 1], P[3, 2] = znear / right, znear / top, 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


def camera(yaw_deg: float, center, width: int, height: int,
           cfg: dict) -> dict:
    """A camera at `center` looking down +z turned by `yaw_deg` about y:
    the transposed world-to-view and full projection matrices (as 3DGS
    keeps them), the centre and the tangents of the half fields of view."""
    fovy = math.radians(cfg["fovy_deg"])
    fovx = 2 * math.atan(math.tan(fovy / 2) * width / height)
    a = math.radians(yaw_deg)
    R = np.array([[math.cos(a), 0.0, math.sin(a)], [0.0, 1.0, 0.0],
                  [-math.sin(a), 0.0, math.cos(a)]])       # camera to world
    c = np.asarray(center, np.float64)
    w2c = np.eye(4)
    w2c[:3, :3] = R.T
    w2c[:3, 3] = -R.T @ c
    view = w2c.T
    proj = view @ projection_matrix(cfg["znear"], cfg["zfar"], fovx, fovy).T
    return dict(view=view.astype(np.float32), proj=proj.astype(np.float32),
                campos=c.astype(np.float32), width=int(width),
                height=int(height), tanfovx=math.tan(fovx / 2),
                tanfovy=math.tan(fovy / 2))


class Camera:
    """The attributes the program's `make_settings` and `camera_arrays`
    read, for a camera dict."""

    def __init__(self, cam: dict):
        self.image_width, self.image_height = cam["width"], cam["height"]
        self.tanfovx, self.tanfovy = cam["tanfovx"], cam["tanfovy"]
        self.world_view_transform = cam["view"]
        self.full_proj_transform = cam["proj"]
        self.camera_center = cam["campos"]
