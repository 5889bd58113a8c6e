"""The least time of each stage of the geometry step (and of a
densification round) on one H100, from the work these inputs need, on
roofline.py's peaks and rules: every input byte read once and every
output byte written once, f32 matrix work (the convolutions) at the TF32
tensor rate, other f32 work at the f32 rate, the work that depends on the
data counted as the reference counts it (render.count_work)."""
from __future__ import annotations

from . import roofline
from .roofline import least_s

# The six trained fields a Gaussian at SH degree d: xyz 3, scale 3,
# rotation 4, opacity 1 and 3 (d + 1)^2 SH coefficients.
BASE_FLOATS = 3 + 3 + 4 + 1
# The screen state the blend reads a Gaussian (xy, conic, opacity, rgb).
SCREEN_FLOATS = 9
# f32 operations of K7 for an included (entry, pixel) pair beyond the
# alpha test (chip_smoke.py's RGB_BWD_INCLUDE_FLOPS).
RGB_BWD_INCLUDE_FLOPS = 42
# Operations a pixel and channel of the loss beyond the window filters:
# L1's difference and sum, the five products and SSIM's map (about 20),
# forward and backward.
LOSS_FLOPS = 60


def fields(sh_degree: int) -> int:
    """Floats of the trained fields a Gaussian."""
    return BASE_FLOATS + 3 * (sh_degree + 1) ** 2


def preprocess_fwd(n: int, sh_degree: int) -> float:
    """The plain preprocess under autograd does the kernel's work."""
    return roofline.preprocess(n, sh_degree)


def preprocess_bwd(n: int, sh_degree: int) -> float:
    """Autograd through the preprocess: the screen state's cotangents and
    the fields read, the fields' gradients and the means2D carrier's
    written; twice the forward's operations."""
    coeffs = (sh_degree + 1) ** 2
    f = fields(sh_degree)
    return least_s(n * 4 * (SCREEN_FLOATS + 2 * f + 2),
                   2 * n * (roofline.PREPROCESS_FLOPS
                            + roofline.SH_FLOPS_PER_COEFF * 3 * coeffs))


def blend(work: dict, tiles: int) -> float:
    """K2 in RGB mode: roofline.blend with no channels and no pairs."""
    return roofline.blend(work, tiles, 0, 0)


def rgb_bwd(work: dict, tiles: int) -> float:
    """K7: the per-pixel pack [T, 256, 5] and the tile ranges read once,
    the needed entries' ids and 36 B of each distinct Gaussian read, a
    row of 9 floats an entry written; the alpha replay of an evaluated
    pair and 42 operations an included one."""
    nbytes = (tiles * 256 * 5 * 4 + tiles * 8 + work["needed"] * 4
              + work["distinct"] * 36 + work["needed"] * 9 * 4)
    return least_s(nbytes, work["evaluated"] * roofline.BLEND_ALPHA_FLOPS
                   + work["included"] * RGB_BWD_INCLUDE_FLOPS)


def reduce(work: dict, n: int) -> float:
    """The entry rows summed into the Gaussians (index_add_): the rows
    and their ids read, [n, 9] written."""
    return least_s(work["needed"] * (9 * 4 + 4) + n * 9 * 4,
                   work["needed"] * 9)


def loss(height: int, width: int, window: int = 11) -> float:
    """L1 + SSIM forward and backward: both images read and the image's
    gradient written; the five window filters of the three channels
    forward and their adjoint backward as matrix work, the rest f32."""
    px = height * width * 3
    return least_s(px * 4 * 3, px * LOSS_FLOPS,
                   2 * 5 * px * 2 * window * window)


def adam(n: int, sh_degree: int) -> float:
    """Adam over the six groups at the whole capacity."""
    return roofline.adam(n * fields(sh_degree))


def densify(n: int, sh_degree: int) -> float:
    """A round: the fields, the statistics and the split noise read, the
    fields written anew and the statistics zeroed."""
    f = fields(sh_degree)
    return least_s(n * 4 * (f + 2 + 6 + f + 3))
