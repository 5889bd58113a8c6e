"""The least time a stage could take on one H100, from the work these
inputs need.

Peaks: NVIDIA's H100 SXM data sheet, dense rates, at the 700 W limit (a
card set below it runs slower under load: the harness reports the card's
`power.limit` beside every share). f32 matrix work counts against the TF32
tensor-core rate, since no tensor-core emulation of f32 can beat it; other
f32 work against the f32 rate outside the tensor cores; bytes against the
HBM3 rate. A stage's least time is the largest of its three times. Every
input byte is counted read once and every output byte written once;
where the work depends on the data (pixels that end early), it counts
what these inputs need, as the reference counts it.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
TF32_TENSOR_FLOPS = 495e12

# f32 operations a pair in a blend (chip_smoke.py's counts): the alpha test
# of an evaluated pair (dx, dy, the conic quadratic, exp, scale, clamp),
# and for an included pair the transmittance step and one multiply-add a
# colour and a (weight, index) pair.
BLEND_ALPHA_FLOPS = 14
PREPROCESS_FLOPS = 180          # projection, EWA conic, radius, rect
SH_FLOPS_PER_COEFF = 6          # a basis term and a multiply-add a colour
GAUSS_BYTES = 4 * (3 + 3 + 4 + 1)          # xyz, scale, rotation, opacity
SCREEN_BYTES = 4 * (2 + 1 + 3 + 1 + 3 + 4 + 1)  # xy depth conic radius rgb rect tiles


def least_s(bytes_=0.0, vec_flops=0.0, mm_flops=0.0) -> float:
    return max(bytes_ / HBM_BYTES_PER_S, vec_flops / F32_FLOPS,
               mm_flops / TF32_TENSOR_FLOPS)


def preprocess(n: int, sh_degree: int) -> float:
    coeffs = (sh_degree + 1) ** 2
    return least_s(n * (GAUSS_BYTES + 12 * coeffs + SCREEN_BYTES),
                   n * (PREPROCESS_FLOPS + SH_FLOPS_PER_COEFF * 3 * coeffs))


def binning(n: int, needed: int, tiles: int) -> float:
    """Read each Gaussian's screen state (xy, depth, conic, opacity, rect),
    write the needed entries' Gaussian ids in order and each tile's range."""
    return least_s(n * 4 * (2 + 1 + 3 + 1 + 4) + needed * 4 + tiles * 8)


def blend(work: dict, tiles: int, channels: int, pairs: int) -> float:
    """K2: ids and ranges, each distinct Gaussian's state (xy, conic,
    opacity, rgb) and pairs read once; the tile maps (channels, rgb, T)
    written once; 14 operations an evaluated pair and 3 + 2 (3 + pairs) an
    included one."""
    nbytes = (work["needed"] * 4 + tiles * 8
              + work["distinct"] * (4 * 9 + 8 * pairs)
              + tiles * 256 * (channels + 4) * 4)
    flops = (work["evaluated"] * BLEND_ALPHA_FLOPS
             + work["included"] * (3 + 2 * (3 + pairs)))
    return least_s(nbytes, flops)


def assemble(tiles: int, height: int, width: int) -> float:
    """The rgb and transmittance tiles read, the images written."""
    return least_s(tiles * 256 * 4 * 4 + height * width * 4 * 4)


def query(tiles: int, levels: int, k: int, n_pos: int, n_neg: int,
          height: int, width: int, clip_dim: int) -> float:
    """K3 and the relevancy: the map read once, the relevancy written once;
    the prompt constants (codebooks folded into the phrases, the codebook
    Gram matrices) and per pixel and level the raw scores (2K a phrase)
    and the squared norm (2K^2 + 2K) as matrix work, the relevancy's
    division, difference and sigmoid (about 16 operations a positive and
    negative) as f32 work."""
    q, pq = tiles * 256, n_pos + n_neg
    nbytes = (q * levels * k * 4 + levels * n_pos * height * width * 4
              + levels * k * (clip_dim + pq + k) * 4 + pq * clip_dim * 4)
    mm = (q * levels * (2 * k * pq + 2 * k * k + 2 * k)
          + levels * k * 2 * clip_dim * (pq + k))
    vec = q * levels * (pq * 2 + n_pos * (n_neg + 16))
    return least_s(nbytes, vec, mm)


def topk_codes(n: int, k_all: int, k: int) -> float:
    """The top-k softmax of each Gaussian's logits: logits read, k weights
    and indices written."""
    return least_s(n * k_all * 4 + n * k * 8, n * k_all * 2)


def gram_fwd(q: int, m: int, table_rows: int, clip_dim: int) -> float:
    """K6a (chip_smoke.py's k6a_work): seg and the map [q, M] read, the
    table's codebook products and G read once, the tile sums written; G w
    (2M^2) as matrix work, n2, num and the chain (4M + 10) a pixel."""
    nbytes = q * (m + 1) * 4 + table_rows * (m + 1) * 4 + m * m * 4 + q // 64
    return least_s(nbytes, q * (4 * m + 10), q * 2 * m * m
                   + 2 * table_rows * m * clip_dim)


def gram_bwd(q: int, m: int, k: int, table_rows: int) -> float:
    """K6b (chip_smoke.py's k6b_work): also d_w [q, C] written, d_phi and
    d_G written once; G w and d_G (2M^2 + 2MK) as matrix work, the chain,
    d_w and d_phi (4M + 10 + 6K) as f32 work."""
    nbytes = (q * (m + 1) * 4 + table_rows * (m + 1) * 4 + m * m * 4
              + q * m * 4 + (table_rows + m) * k * 4)
    return least_s(nbytes, q * (4 * m + 10 + 6 * k),
                   q * (2 * m * m + 2 * m * k))


def feature_bwd(work: dict, tiles: int, channels: int) -> float:
    """K4 (chip_smoke.py's count): ids and ranges, 24 B a distinct
    Gaussian, the map's cotangent read once and a channel row an entry
    written; the alpha replay of an evaluated pair and the transmittance
    step of an included one as f32 work, its W^T g row (2C) as matrix
    work."""
    nbytes = (work["needed"] * 4 + tiles * 8 + work["distinct"] * 24
              + tiles * 256 * channels * 4 + work["needed"] * channels * 4)
    return least_s(nbytes, work["evaluated"] * BLEND_ALPHA_FLOPS
                   + work["included"] * 3, work["included"] * 2 * channels)


def pair_grads(n: int, k_all: int, k: int) -> float:
    """d(logits) from d(pair weights): the softmax's backward scattered to
    the logits (read and written once)."""
    return least_s(n * k * 8 + n * k_all * 4 * 2, n * k * 6)


def adam(numel: int) -> float:
    """Adam: parameter, gradient and both moments read, parameter and both
    moments written, about 12 operations an element."""
    return least_s(numel * 4 * 7, numel * 12)
