"""Real spherical harmonics, degrees 0..4 (port of langsplatv2_tpu/utils/sh.py)."""
from __future__ import annotations

import torch

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
      -1.0925484305920792, 0.5462742152960396)
C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
      0.3731763325901154, -0.4570457994644658, 1.445305721320277,
      -0.5900435899266435)
C4 = (2.5033429417967046, -1.7701307697799304, 0.9461746957575601,
      -0.6690465435572892, 0.10578554691520431, -0.6690465435572892,
      0.47308734787878004, -1.7701307697799304, 0.6258357354491761)


def eval_sh(deg: int, sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """sh [..., C, K] with K >= (deg+1)^2, unit dirs [..., 3] -> [..., C]."""
    if not 0 <= deg <= 4:
        raise ValueError(f"SH degree {deg} is outside 0..4")
    if sh.shape[-1] < (deg + 1) ** 2:
        raise ValueError(f"{sh.shape[-1]} SH coefficients for degree {deg}")
    result = C0 * sh[..., 0]
    if deg > 0:
        x, y, z = dirs[..., 0:1], dirs[..., 1:2], dirs[..., 2:3]
        result = (result - C1 * y * sh[..., 1] + C1 * z * sh[..., 2]
                  - C1 * x * sh[..., 3])
        if deg > 1:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            result = (result
                      + C2[0] * xy * sh[..., 4]
                      + C2[1] * yz * sh[..., 5]
                      + C2[2] * (2.0 * zz - xx - yy) * sh[..., 6]
                      + C2[3] * xz * sh[..., 7]
                      + C2[4] * (xx - yy) * sh[..., 8])
            if deg > 2:
                result = (result
                          + C3[0] * y * (3 * xx - yy) * sh[..., 9]
                          + C3[1] * xy * z * sh[..., 10]
                          + C3[2] * y * (4 * zz - xx - yy) * sh[..., 11]
                          + C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * sh[..., 12]
                          + C3[4] * x * (4 * zz - xx - yy) * sh[..., 13]
                          + C3[5] * z * (xx - yy) * sh[..., 14]
                          + C3[6] * x * (xx - 3 * yy) * sh[..., 15])
                if deg > 3:
                    result = (
                        result
                        + C4[0] * xy * (xx - yy) * sh[..., 16]
                        + C4[1] * yz * (3 * xx - yy) * sh[..., 17]
                        + C4[2] * xy * (7 * zz - 1) * sh[..., 18]
                        + C4[3] * yz * (7 * zz - 3) * sh[..., 19]
                        + C4[4] * (zz * (35 * zz - 30) + 3) * sh[..., 20]
                        + C4[5] * xz * (7 * zz - 3) * sh[..., 21]
                        + C4[6] * (xx - yy) * (7 * zz - 1) * sh[..., 22]
                        + C4[7] * xz * (xx - 3 * yy) * sh[..., 23]
                        + C4[8] * (xx * (xx - 3 * yy) - yy * (3 * xx - yy))
                        * sh[..., 24])
    return result


def eval_sh_basis(deg: int, dirs: torch.Tensor) -> list:
    """[(B_k [...], dB_k / d(x, y, z) [..., 3])] for every coefficient k of
    degree `deg`: eval_sh is sum_k B_k sh_k. The gradient is that of the
    polynomial as eval_sh writes it (the direction's unit length unused),
    so it is autograd's (csrc/preprocess_bwd.cu's `basis`)."""
    if not 0 <= deg <= 4:
        raise ValueError(f"SH degree {deg} is outside 0..4")
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    one, zero = torch.ones_like(x), torch.zeros_like(x)
    rows = [(C0 * one, (zero, zero, zero))]
    if deg > 0:
        rows += [(-C1 * y, (zero, -C1 * one, zero)),
                 (C1 * z, (zero, zero, C1 * one)),
                 (-C1 * x, (-C1 * one, zero, zero))]
    if deg > 1:
        a = C2
        rows += [(a[0] * (x * y), (a[0] * y, a[0] * x, zero)),
                 (a[1] * (y * z), (zero, a[1] * z, a[1] * y)),
                 (a[2] * (2.0 * zz - xx - yy),
                  (a[2] * (-2.0 * x), a[2] * (-2.0 * y), a[2] * (4.0 * z))),
                 (a[3] * (x * z), (a[3] * z, zero, a[3] * x)),
                 (a[4] * (xx - yy), (a[4] * (2.0 * x), a[4] * (-2.0 * y),
                                     zero))]
    if deg > 2:
        a = C3
        rows += [(a[0] * y * (3 * xx - yy), (a[0] * 6 * x * y,
                                            a[0] * (3 * xx - 3 * yy), zero)),
                 (a[1] * x * y * z, (a[1] * y * z, a[1] * x * z,
                                     a[1] * x * y)),
                 (a[2] * y * (4 * zz - xx - yy),
                  (a[2] * -2 * x * y, a[2] * (4 * zz - xx - 3 * yy),
                   a[2] * 8 * y * z)),
                 (a[3] * z * (2 * zz - 3 * xx - 3 * yy),
                  (a[3] * -6 * x * z, a[3] * -6 * y * z,
                   a[3] * (6 * zz - 3 * xx - 3 * yy))),
                 (a[4] * x * (4 * zz - xx - yy),
                  (a[4] * (4 * zz - 3 * xx - yy), a[4] * -2 * x * y,
                   a[4] * 8 * x * z)),
                 (a[5] * z * (xx - yy), (a[5] * 2 * x * z, a[5] * -2 * y * z,
                                         a[5] * (xx - yy))),
                 (a[6] * x * (xx - 3 * yy), (a[6] * (3 * xx - 3 * yy),
                                             a[6] * -6 * x * y, zero))]
    if deg > 3:
        a = C4
        rows += [(a[0] * x * y * (xx - yy), (a[0] * y * (3 * xx - yy),
                                             a[0] * x * (xx - 3 * yy), zero)),
                 (a[1] * y * z * (3 * xx - yy),
                  (a[1] * 6 * x * y * z, a[1] * z * (3 * xx - 3 * yy),
                   a[1] * y * (3 * xx - yy))),
                 (a[2] * x * y * (7 * zz - 1),
                  (a[2] * y * (7 * zz - 1), a[2] * x * (7 * zz - 1),
                   a[2] * 14 * x * y * z)),
                 (a[3] * y * z * (7 * zz - 3),
                  (zero, a[3] * z * (7 * zz - 3), a[3] * y * (21 * zz - 3))),
                 (a[4] * (zz * (35 * zz - 30) + 3),
                  (zero, zero, a[4] * z * (140 * zz - 60))),
                 (a[5] * x * z * (7 * zz - 3),
                  (a[5] * z * (7 * zz - 3), zero, a[5] * x * (21 * zz - 3))),
                 (a[6] * (xx - yy) * (7 * zz - 1),
                  (a[6] * 2 * x * (7 * zz - 1), a[6] * -2 * y * (7 * zz - 1),
                   a[6] * 14 * z * (xx - yy))),
                 (a[7] * x * z * (xx - 3 * yy),
                  (a[7] * z * (3 * xx - 3 * yy), a[7] * -6 * x * y * z,
                   a[7] * x * (xx - 3 * yy))),
                 (a[8] * (xx * (xx - 3 * yy) - yy * (3 * xx - yy)),
                  (a[8] * 4 * x * (xx - 3 * yy), a[8] * 4 * y * (yy - 3 * xx),
                   zero))]
    return [(b, torch.stack(g, -1)) for b, g in rows]


def rgb_to_sh(rgb):
    """RGB in [0, 1] -> degree-0 coefficient."""
    return (rgb - 0.5) / C0
