"""The preprocess under autograd: `projection.preprocess_grads_plain`,
the plain twin of csrc/preprocess_bwd.cu, against autograd through
`preprocess_plain` and against the JAX package's VJP of its preprocess;
the dispatch rule of `projection.preprocess`; `PreprocessGrad`'s wiring
(its launches stood in for by the plain versions); and, on the card, the
Function's forward and backward against the plain path, and geometry
steps on both routes.

Rows on every mask's edge: a view-space x and y exactly on the 1.3 tanfov
clamp (the gradient passes, torch's clamp being inclusive), behind the
camera, det exactly 0, an SH colour clamped at 0, culled ones (off the
screen, under the cull opacity), rows whose cotangents are all 0, and a
dead row at the camera centre (depth 0: autograd's gradient is NaN there,
the adjoint's 0, and `rgb_step` zeroes dead rows either way). Tolerance:
1e-5 of each leaf's largest gradient (the two sum in other orders; 2e-6
was read).

The card tests skip without a CUDA device, and the file imports JAX only
inside the JAX test, so on a machine with only torch the card cases run
as

    python -m pytest --noconftest tests/test_torch_port_preprocess_grad.py -q
"""
import math
import re

import numpy as np
import pytest
import torch

from langsplatv2_tpu_torch import tracing
from langsplatv2_tpu_torch.ops import kernels, projection
from langsplatv2_tpu_torch.utils import sh as sh_mod
from langsplatv2_tpu_torch.utils.camera_math import get_projection_matrix

from torch_port_fixtures import scene

SIDE = 64                   # a square image: tanfovx = tanfovy
TANFOV = math.tan(math.radians(30.0))
TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _camera(kind: str):
    """(view, proj, campos) float32 numpy. "axis": looking down +z from
    (0, 0, -0.5), so a view-space coordinate is the world one (a row can
    sit on the clamp's edge to the bit); "turned": 20 degrees about y and
    10 about x from (0.3, -0.2, -0.6)."""
    if kind == "axis":
        R, c = np.eye(3), np.array([0.0, 0.0, -0.5])
    else:
        a, b = math.radians(20.0), math.radians(10.0)
        ry = np.array([[math.cos(a), 0, math.sin(a)], [0, 1, 0],
                       [-math.sin(a), 0, math.cos(a)]])
        rx = np.array([[1, 0, 0], [0, math.cos(b), -math.sin(b)],
                       [0, math.sin(b), math.cos(b)]])
        R, c = ry @ rx, np.array([0.3, -0.2, -0.6])
    w2c = np.eye(4)
    w2c[:3, :3] = R.T
    w2c[:3, 3] = -R.T @ c
    fov = 2 * math.atan(TANFOV)
    view = w2c.T
    proj = view @ get_projection_matrix(0.01, 100.0, fov, fov).T.astype(
        np.float64)
    return (view.astype(np.float32), proj.astype(np.float32),
            c.astype(np.float32))


def _case(n: int, deg: int, seed: int, kind: str = "axis"):
    """numpy inputs at SH degree `deg` with the edge rows (module
    docstring) in rows 0..23, and cotangents: every row's nonzero but
    every 11th row's and the dead row's. Returns (fields, edges), edges
    naming the rows of each kind."""
    rng = np.random.default_rng(seed)
    sc = scene(n, seed=seed)
    view, proj, campos = _camera(kind)
    means = sc["means"].copy()
    means[:, :2] *= 0.6
    scales, rots = sc["scales"].copy(), sc["rotations"].copy()
    ops = sc["opacities"][:, 0].copy()
    k = (deg + 1) ** 2
    shs = (rng.normal(size=(n, k, 3)) * 0.3).astype(np.float32)
    lim = np.float32(1.3 * TANFOV)
    # On the clamp's edge (axis camera: tz = mz + 0.5 = 2, pv = m).
    means[0:4] = [[2 * lim, 0.1, 1.5], [-2 * lim, 0.1, 1.5],
                  [0.1, 2 * lim, 1.5], [0.2, -2 * lim, 1.5]]
    # Past it, behind the camera, at the near plane.
    means[4:6] = [[3.0, 0.0, 1.5], [0.0, -3.0, 1.5]]
    means[6:8, 2] = [-1.5, -3.5]
    means[8, 2] = np.float32(0.2) - np.float32(0.5)
    # det == 0 (axis camera): on the diagonal (tx = ty, so j2 = k2),
    # identity rotation, one scale so large that a = b = c. (Under another
    # view such a row is near det = 0 and too ill-conditioned to compare.)
    if kind == "axis":
        means[9:11] = [[0.5, 0.5, 1.5], [-0.25, -0.25, 1.5]]
        rots[9:11] = [1.0, 0.0, 0.0, 0.0]
        scales[9:11] = [0.0, 0.0, 4096.0]
    # SH colour clamped at 0 on every channel.
    shs[11:13, 0] = -8.0
    shs[11:13, 1:] = 0.0
    # Culled: off the screen, under the cull opacity.
    means[13:15] = [[40.0, 0.0, 3.0], [0.0, -30.0, 3.0]]
    ops[15:17] = [0.0, 1e-3]
    # Dead: at the camera centre, zero cotangents.
    dead = 17
    means[dead] = campos
    rots[dead] = [1.0, 0.0, 0.0, 0.0]
    shs[dead] = 0.0
    cot = [rng.normal(size=(n, w)).astype(np.float32) for w in (2, 3, 3)]
    for g in cot:
        g[24::11] = 0.0
        g[dead] = 0.0
    fields = dict(means=means, scales=scales, rotations=rots, shs=shs,
                  ops=ops, view=view, proj=proj, campos=campos, g_xy=cot[0],
                  g_conic=cot[1], g_rgb=cot[2], deg=deg)
    edges = dict(clamp=[0, 1, 2, 3], det0=[9, 10] if kind == "axis" else [],
                 clamped=[11, 12], dead=[dead])
    return fields, edges


def _args(f, dev="cpu", form="pair", grad=False):
    """The preprocess's positional arguments from `_case`'s fields as
    tensors on `dev` (leaves requiring grad with `grad`), and the leaves."""
    def T(a):
        t = torch.as_tensor(a, device=dev).clone()
        return t.requires_grad_(grad)

    shs = torch.as_tensor(f["shs"], device=dev)
    leaves = dict(means=T(f["means"]), scales=T(f["scales"]),
                  rotations=T(f["rotations"]),
                  dc=shs[:, :1].clone().requires_grad_(grad),
                  rest=shs[:, 1:].clone().requires_grad_(grad))
    if form == "pair":
        sh_arg = (leaves["dc"], leaves["rest"])
    else:
        whole = shs.clone().requires_grad_(grad)
        leaves.update(dc=None, rest=None, shs=whole)
        sh_arg = whole
    args = (leaves["means"], leaves["scales"], leaves["rotations"], sh_arg,
            None, f["view"], f["proj"], f["campos"], TANFOV, TANFOV, SIDE,
            SIDE, f["deg"])
    return args, leaves


def _cots(f, dev="cpu"):
    return {k: torch.as_tensor(f[k], device=dev)
            for k in ("g_xy", "g_conic", "g_rgb")}


def _autograd(f, form, sm, opacities: bool, dev="cpu", cov=None):
    """Autograd through preprocess_plain: {leaf: gradient}."""
    args, leaves = _args(f, dev, form, grad=True)
    if cov is not None:
        args = (args[0], None, None) + args[3:]
    kw = dict(opacities=torch.as_tensor(f["ops"], device=dev)
              if opacities else None, cov3d_precomp=cov)
    out = projection.preprocess_plain(*args, sm, **kw)
    cots = _cots(f, dev)
    torch.autograd.backward([out.xy, out.conic, out.rgb],
                            [cots["g_xy"], cots["g_conic"], cots["g_rgb"]])
    return _leaf_grads(leaves, form)


def _leaf_grads(leaves, form):
    got = {k: leaves[k].grad for k in ("means", "scales", "rotations")}
    if form == "pair":
        got.update(dc=leaves["dc"].grad, rest=leaves["rest"].grad)
    else:
        whole = leaves["shs"].grad
        got.update(dc=whole[:, :1], rest=whole[:, 1:])
    return got


def _adjoint(f, form, sm, fn=projection.preprocess_grads_plain, dev="cpu",
             cov=None):
    args, _ = _args(f, dev, form)
    if cov is not None:
        args = (args[0], None, None) + args[3:]
    d_means, d_scales, d_rot, d_shs = fn(*args, sm, **_cots(f, dev),
                                          cov3d_precomp=cov)
    dc, rest = d_shs if form == "pair" else (d_shs[:, :1], d_shs[:, 1:])
    return dict(means=d_means, scales=d_scales, rotations=d_rot, dc=dc,
                rest=rest)


def _compare(got, want, rows, tol=TOL, label=""):
    """Each leaf on `rows` within tol of the leaf's largest |want|."""
    for k in want:
        if want[k] is None:
            assert got[k] is None, (label, k)
            continue
        a, b = got[k][rows].double(), want[k][rows].double()
        assert a.shape == b.shape, (label, k)
        if not b.numel():
            continue
        assert torch.isfinite(a).all(), (label, k)
        scale = float(b.abs().max())
        if scale == 0.0:
            assert float(a.abs().max()) == 0.0, (label, k)
            continue
        err = float((a - b).abs().max()) / scale
        assert err <= tol, f"{label} {k}: {err:.3g} of the largest"


def _live(n, edges):
    keep = torch.ones(n, dtype=torch.bool)
    keep[edges["dead"]] = False
    return keep


def _same_bits(got, want, label):
    assert got.dtype == want.dtype and got.shape == want.shape, label
    if got.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    bad = int((got != want).sum())
    assert bad == 0, f"{label}: {bad} of {got.numel()} values differ"


# ------------------------------------------------------------ on the CPU

CASES = [(0, "pair", 1.0, True), (1, "whole", 1.0, False),
         (2, "pair", 0.9, False), (3, "pair", 1.0, True),
         (3, "whole", 0.7, True), (0, "whole", 1.3, False),
         (1, "pair", 0.9, True), (2, "whole", 1.0, True)]


@pytest.mark.parametrize("deg,form,sm,opacities", CASES)
@pytest.mark.parametrize("kind", ["axis", "turned"])
def test_plain_adjoint_matches_autograd(deg, form, sm, opacities, kind):
    """preprocess_grads_plain against autograd through preprocess_plain:
    every leaf on every row but the dead one within 1e-5 of its largest;
    the dead row's gradients exactly 0; the SH rows of a colour clamped on
    every channel exactly 0."""
    f, edges = _case(600, deg, seed=deg + 10 * len(form), kind=kind)
    want = _autograd(f, form, sm, opacities)
    got = _adjoint(f, form, sm)
    live = _live(600, edges)
    _compare(got, want, live, label=f"deg {deg} {form} {kind}")
    for k, v in got.items():
        if v.numel():
            assert not v[edges["dead"]].any(), k
        if k in ("dc", "rest") and v.numel():
            assert not v[edges["clamped"]].any(), k


def test_edge_rows_sit_on_their_edges():
    """The axis camera's edge rows are what they claim: x / tz or y / tz
    exactly the clamp bound, det exactly 0 (conic 0, radius 0), the SH
    colour 0 before its clamp is negative, culled rows radius 0, the dead
    row at depth 0."""
    f, edges = _case(200, 3, seed=1)
    args, _ = _args(f)
    view = torch.as_tensor(f["view"])
    t = projection._ewa_terms(args[0], args[1], args[2], view,
                              torch.as_tensor(f["proj"]), TANFOV, TANFOV,
                              SIDE, SIDE)
    lim = torch.tensor(1.3 * TANFOV, dtype=torch.float32)
    w = torch.stack([t.wx, t.wy], 1)[edges["clamp"]]
    assert bool(((w.abs() == lim).sum(1) == 1).all()), w
    assert bool((t.det[edges["det0"]] == 0).all())
    out = projection.preprocess_plain(*args, opacities=torch.as_tensor(
        f["ops"]))
    assert int(out.radius[edges["det0"] + [6, 7, 13, 14, 15, 16]].abs()
               .sum()) == 0
    assert float(out.rgb[edges["clamped"]].abs().max()) == 0.0
    assert float(t.depth[edges["dead"][0]]) == 0.0
    assert int((out.radius > 0).sum()) > 150


def _cov_case(n: int, deg: int, seed: int, dev="cpu"):
    """`_case` on the axis camera with cov3d_precomp [n, 6] from the
    scales and rotations, rows 20 and 21 on the optical axis with a = 0
    (xx = -0.3 / j0^2 to the bit) and b = 0 (xy = 0): det exactly 0."""
    from langsplatv2_tpu_torch.utils.transforms import \
        covariance_from_scaling_rotation
    f, edges = _case(n, deg, seed)
    f["means"][20:22] = [0.0, 0.0, 3.5]
    cov = covariance_from_scaling_rotation(
        torch.as_tensor(f["scales"]), 1.0, torch.as_tensor(f["rotations"]))
    t = projection._ewa_terms(torch.as_tensor(f["means"][20:21]), None,
                              None, torch.as_tensor(f["view"]),
                              torch.as_tensor(f["proj"]), TANFOV, TANFOV,
                              SIDE, SIDE, cov3d_precomp=torch.ones(1, 6))
    jj = np.float32(t.m0[0, 0]) * np.float32(t.m0[0, 0])
    xx = np.float32(-0.3) / jj
    for _ in range(64):
        if np.float32(jj * xx) == np.float32(-0.3):
            break
        xx = np.nextafter(xx, np.float32(0) if np.float32(jj * xx)
                          < np.float32(-0.3) else np.float32(-1))
    cov[20:22] = torch.tensor([float(xx), 0.0, 0.0, 1.0, 0.0, 1.0])
    edges["det0"] = [20, 21]
    return f, edges, cov.to(dev)


@pytest.mark.parametrize("deg", [0, 3])
def test_plain_adjoint_with_cov3d_precomp(deg):
    """With cov3d_precomp (no gradient of its own, rows whose det is
    exactly 0), means3d and the SH rows against autograd; d_scales and
    d_rotations are None."""
    f, edges, cov = _cov_case(400, deg, seed=7)
    t = projection._ewa_terms(torch.as_tensor(f["means"]), None, None,
                              torch.as_tensor(f["view"]),
                              torch.as_tensor(f["proj"]), TANFOV, TANFOV,
                              SIDE, SIDE, cov3d_precomp=cov)
    assert bool((t.det[edges["det0"]] == 0).all())
    want = _autograd(f, "pair", 1.0, True, cov=cov)
    got = _adjoint(f, "pair", 1.0, cov=cov)
    assert got["scales"] is None and got["rotations"] is None
    want.update(scales=None, rotations=None)
    _compare(got, want, _live(400, edges), label=f"cov3d deg {deg}")


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_plain_adjoint_matches_jax_vjp(deg):
    """preprocess_grads_plain against jax.vjp of the JAX package's
    preprocess (jitted, on the CPU) with the same cotangents, within 1e-5
    of each leaf's largest. The clamp-edge rows are left out: jnp.clip's
    gradient at its bound is shared (jnp.maximum's tie rule), torch's
    clamp passes it whole; and the dead row (NaN in both)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from langsplatv2_tpu.ops import projection as jax_projection

    f, edges = _case(500, deg, seed=20 + deg, kind="turned")
    ops = jnp.asarray(f["ops"])

    def fwd(means, scales, rots, shs):
        out = jax_projection.preprocess(
            means, scales, rots, None, shs, None, jnp.asarray(f["view"]),
            jnp.asarray(f["proj"]), jnp.asarray(f["campos"]), TANFOV, TANFOV,
            SIDE, SIDE, deg, 0.9, opacities=ops)
        return out.xy, out.conic, out.rgb

    def vjp(means, scales, rots, shs, g_xy, g_conic, g_rgb):
        _, pull = jax.vjp(fwd, means, scales, rots, shs)
        return pull((g_xy, g_conic, g_rgb))

    jg = jax.jit(vjp)(*(jnp.asarray(f[k]) for k in (
        "means", "scales", "rotations", "shs", "g_xy", "g_conic", "g_rgb")))
    jg = [torch.from_numpy(np.array(a)) for a in jg]
    want = dict(means=jg[0], scales=jg[1], rotations=jg[2],
                dc=jg[3][:, :1], rest=jg[3][:, 1:])
    got = _adjoint(f, "whole", 0.9)
    rows = _live(500, edges)
    rows[edges["clamp"]] = False
    _compare(got, want, rows, label=f"JAX deg {deg}")


@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
def test_sh_basis_sums_to_eval_sh(deg):
    """eval_sh_basis: sum_k B_k sh_k is eval_sh, and each B_k's gradient
    is autograd's of eval_sh with sh = e_k."""
    gen = torch.Generator().manual_seed(deg)
    dirs = torch.nn.functional.normalize(torch.randn(64, 3, generator=gen),
                                         dim=-1)
    k = (deg + 1) ** 2
    sh = torch.randn(64, 3, k, generator=gen)
    basis = sh_mod.eval_sh_basis(deg, dirs)
    assert len(basis) == k
    total = sum(b[:, None] * sh[..., i] for i, (b, _) in enumerate(basis))
    torch.testing.assert_close(total, sh_mod.eval_sh(deg, sh, dirs),
                               rtol=1e-5, atol=1e-5)
    if deg == 0:
        assert not basis[0][1].any()
        return
    for i, (_, grad) in enumerate(basis):
        d = dirs.clone().requires_grad_(True)
        e = torch.zeros(64, 1, k)
        e[..., i] = 1.0
        sh_mod.eval_sh(deg, e, d).sum().backward()
        torch.testing.assert_close(grad, d.grad, rtol=1e-5, atol=1e-6)


def _rule_inputs():
    f, _ = _case(32, 1, seed=3)
    args, leaves = _args(f)
    return args, leaves, torch.as_tensor(f["ops"])


@pytest.mark.parametrize("case,expect", [
    ("none", "kernel"), ("grad_off", "kernel"), ("means", "grad"),
    ("scales", "grad"), ("dc", "grad"), ("whole", "grad"),
    ("opacities", "grad"), ("cov_no_grad", "grad"), ("cov_grad", "plain"),
    ("colors_grad", "plain"), ("colors_no_grad", "grad"),
    ("campos_grad", "plain"), ("cpu", "plain")])
def test_dispatch_rule(monkeypatch, case, expect):
    """Which route `preprocess` takes, its CUDA half with the card faked:
    the kernel when nothing needs a gradient; PreprocessGrad when only the
    geometry, SH or opacity inputs do, cov3d_precomp and colors_precomp
    included when they need none; the plain path when cov3d_precomp,
    colors_precomp or the camera needs one (PreprocessGrad gives them
    none), and always on the CPU."""
    taken = []
    for name in ("preprocess_kernel", "preprocess_grad", "preprocess_plain"):
        monkeypatch.setattr(projection, name,
                            lambda *a, _n=name, **k: taken.append(_n))
    args, leaves, ops = _rule_inputs()
    args = list(args)
    kw = dict(opacities=ops, cov3d_precomp=None)
    if case != "cpu":
        monkeypatch.setattr(projection, "_on_card", lambda t: True)
    if case in ("means", "scales", "grad_off"):
        args[0 if case != "scales" else 1] = \
            args[0 if case != "scales" else 1].requires_grad_(True)
    elif case == "dc":
        args[3] = (leaves["dc"].requires_grad_(True), leaves["rest"])
    elif case == "whole":
        args[3] = torch.cat(args[3], 1).requires_grad_(True)
    elif case == "opacities":
        kw["opacities"] = ops.requires_grad_(True)
    elif case.startswith("cov"):
        kw["cov3d_precomp"] = torch.ones(32, 6, requires_grad=case
                                         == "cov_grad")
        args[0].requires_grad_(True)
    elif case.startswith("colors"):
        args[4] = torch.ones(32, 3, requires_grad=case == "colors_grad")
        args[0].requires_grad_(True)
    elif case == "campos_grad":
        args[7] = torch.zeros(3, requires_grad=True)
        args[0].requires_grad_(True)
    elif case == "cpu":
        args[0].requires_grad_(True)
    with torch.set_grad_enabled(case != "grad_off"):
        projection.preprocess(*args, 1.0, **kw)
    assert taken == ["preprocess_" + {"kernel": "kernel", "grad": "grad",
                                      "plain": "plain"}[expect]]


def _plain_launches(monkeypatch, f, sm):
    """PreprocessGrad's two launches stood in for by the plain versions
    on the CPU (the camera and scalars of `f`), to hold its wiring."""
    def fwd(x, colors_precomp):
        shs = None if x.dc is None else torch.cat([x.dc, x.rest], 1)
        with torch.no_grad():
            return projection.preprocess_plain(
                x.means, x.scl, x.rot, shs, colors_precomp, f["view"],
                f["proj"], f["campos"], TANFOV, TANFOV, SIDE, SIDE,
                max(x.deg, 0), sm, opacities=x.op, cov3d_precomp=x.cov)

    def bwd(x, g_xy, g_conic, g_rgb, whole, k_shs):
        shs = None if x.deg < 0 else (torch.cat([x.dc, x.rest], 1) if whole
                                      else (x.dc, x.rest))
        return projection.preprocess_grads_plain(
            x.means, x.scl, x.rot, shs, None, f["view"], f["proj"],
            f["campos"], TANFOV, TANFOV, SIDE, SIDE, x.deg, sm, g_xy=g_xy,
            g_conic=g_conic, g_rgb=g_rgb, cov3d_precomp=x.cov)

    monkeypatch.setattr(projection, "_forward_launch", fwd)
    monkeypatch.setattr(projection, "_grads_launch", bwd)


@pytest.mark.parametrize("form", ["pair", "whole"])
def test_function_wiring(monkeypatch, form):
    """PreprocessGrad with its launches stood in for by the plain
    versions: the outputs are preprocess_plain's, each cotangent reaches
    the leaf it belongs to (xy alone, conic alone, rgb alone), and the
    integer outputs, depth and the rects take no gradient."""
    f, edges = _case(300, 2, seed=5, kind="turned")
    _plain_launches(monkeypatch, f, 0.9)
    ops = torch.as_tensor(f["ops"])
    for only in ("g_xy", "g_conic", "g_rgb"):
        g = {k: torch.as_tensor(f[k]) * (k == only) for k in
             ("g_xy", "g_conic", "g_rgb")}
        ref = dict(f, **{k: v.numpy() for k, v in g.items()})
        args, leaves = _args(f, form=form, grad=True)
        out = projection.preprocess_grad(*args, 0.9, opacities=ops)
        plain = projection.preprocess_plain(*_args(f, form=form)[0], 0.9,
                                            opacities=ops)
        for name in plain._fields:
            _same_bits(getattr(out, name).detach(), getattr(plain, name),
                       name)
        for name in ("depth", "radius", "rect_min", "rect_max",
                     "tiles_touched"):
            assert not getattr(out, name).requires_grad, name
        torch.autograd.backward([out.xy, out.conic, out.rgb],
                                [g["g_xy"], g["g_conic"], g["g_rgb"]])
        _compare(_leaf_grads(leaves, form),
                 _autograd(ref, form, 0.9, True), _live(300, edges),
                 label=f"{form} {only}")


def test_function_colors_precomp_and_no_cotangent(monkeypatch):
    """With colors_precomp (no gradient) the rgb field is colors_precomp
    itself and the SH inputs take none; a backward from conic alone
    leaves the xy and rgb cotangents None (read as zero)."""
    f, edges = _case(200, 1, seed=6)
    _plain_launches(monkeypatch, f, 1.0)
    args, leaves = _args(f, grad=True)
    colors = torch.rand(200, 3)
    args = args[:3] + (None, colors) + args[5:]
    out = projection.preprocess_grad(*args, 1.0)
    assert out.rgb is colors
    out.conic.backward(torch.as_tensor(f["g_conic"]))
    assert leaves["dc"].grad is None and leaves["rest"].grad is None
    ref = dict(f, g_xy=f["g_xy"] * 0, g_rgb=f["g_rgb"] * 0)
    want = _autograd(ref, "pair", 1.0, False)
    got = {k: leaves[k].grad for k in ("means", "scales", "rotations")}
    _compare(got, {k: want[k] for k in got}, _live(200, edges))


def test_bwd_kernel_shares_the_forward_params():
    """csrc/preprocess_bwd.cu's `Params` and SH constants are
    csrc/preprocess.cu's, field for field, and its entry points are in
    kernels.SOURCES / ENTRY_POINTS."""
    fwd = (kernels.CSRC / "preprocess.cu").read_text()
    bwd = (kernels.CSRC / "preprocess_bwd.cu").read_text()

    def struct(src):
        body = re.search(r"struct Params \{(.*?)\};", src, re.S).group(1)
        return [line.split("//")[0].strip() for line in body.splitlines()]

    assert struct(fwd) == struct(bwd)
    consts = re.compile(r"constexpr double (kC\w+) = ([-0-9.e]+);")
    assert consts.findall(fwd) == consts.findall(bwd)
    assert len(consts.findall(bwd)) == 23
    assert "preprocess_bwd.cu" in kernels.SOURCES
    assert "-fmad=false" in kernels.SOURCES["preprocess_bwd.cu"]
    for name in ("lsv2_preprocess_bwd", "lsv2_preprocess_bwd_occupancy"):
        assert name in kernels.ENTRY_POINTS


# ------------------------------------------------------------ on the card

def _grad_counts():
    c = tracing.counters()
    return {k: c.get(k, 0) for k in ("preprocess.launches",
                                     "preprocess.grad_launches",
                                     "preprocess.plain_calls")}


@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
def test_card_forward_bit_equal(cuda, deg):
    """PreprocessGrad's forward (csrc/preprocess.cu) against
    preprocess_plain under autograd on the card: every field bit for bit,
    one kernel launch, no plain call."""
    f, _ = _case(5000, deg, seed=40 + deg, kind="turned")
    ops = torch.as_tensor(f["ops"], device=cuda)
    for form in ("pair", "whole"):
        args, _ = _args(f, cuda, form, grad=True)
        before = _grad_counts()
        out = projection.preprocess(*args, 0.9, opacities=ops)
        grown = {k: v - before[k] for k, v in _grad_counts().items()}
        assert grown == {"preprocess.launches": 1,
                         "preprocess.grad_launches": 0,
                         "preprocess.plain_calls": 0}, grown
        assert out.xy.requires_grad and out.conic.requires_grad
        ref = projection.preprocess_plain(*args, 0.9, opacities=ops)
        for name in ref._fields:
            _same_bits(getattr(out, name).detach(),
                       getattr(ref, name).detach(), f"deg {deg} {name}")


@pytest.mark.parametrize("deg,form,cov", [
    (0, "pair", False), (1, "whole", False), (2, "pair", False),
    (3, "pair", False), (3, "whole", False), (4, "pair", False),
    (3, "pair", True)])
def test_card_backward_kernel(cuda, deg, form, cov):
    """preprocess_grads_kernel against preprocess_grads_plain on the card
    (every row, the dead one included) and against autograd through the
    plain path (the live rows), within 1e-5 of each leaf's largest."""
    from langsplatv2_tpu_torch.utils.transforms import \
        covariance_from_scaling_rotation
    f, edges = _case(20000, deg, seed=60 + deg, kind="turned")
    c = None
    if cov:
        c = covariance_from_scaling_rotation(
            torch.as_tensor(f["scales"], device=cuda), 1.0,
            torch.as_tensor(f["rotations"], device=cuda))
    got = _adjoint(f, form, 0.9, projection.preprocess_grads_kernel, cuda,
                   cov=c)
    plain = _adjoint(f, form, 0.9, dev=cuda, cov=c)
    _compare(got, plain, torch.ones(20000, dtype=torch.bool, device=cuda),
             label=f"kernel vs plain deg {deg} {form}")
    want = _autograd(f, form, 0.9, True, cuda, cov=c)
    if cov:
        want.update(scales=None, rotations=None)
    _compare(got, want, _live(20000, edges).to(cuda),
             label=f"kernel vs autograd deg {deg} {form}")


def test_card_backward_at_the_cell_size(cuda):
    """At the geometry cell's width (1,250,048 slots, the last 250,048
    dead, SH 3): the backward kernel against the plain adjoint and
    autograd, no stream synchronisation on the Function's route."""
    n, live = 1_250_048, 1_000_000
    f, _ = _case(n, 3, seed=80, kind="turned")
    for k in ("g_xy", "g_conic", "g_rgb"):
        f[k][live:] = 0.0
    f["means"][live:] = 0.0
    f["rotations"][live:] = [1.0, 0.0, 0.0, 0.0]
    keep = torch.ones(n, dtype=torch.bool, device=cuda)
    keep[17] = False
    got = _adjoint(f, "pair", 1.0, projection.preprocess_grads_kernel, cuda)
    _compare(got, _adjoint(f, "pair", 1.0, dev=cuda), keep | True,
             label="1M kernel vs plain")
    _compare(got, _autograd(f, "pair", 1.0, True, cuda), keep,
             label="1M kernel vs autograd")
    args, leaves = _args(f, cuda, "pair", grad=True)
    ops = torch.as_tensor(f["ops"], device=cuda)
    cots = _cots(f, cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = projection.preprocess(*args, 1.0, opacities=ops)
        torch.autograd.backward([out.xy, out.conic, out.rgb],
                                [cots["g_xy"], cots["g_conic"],
                                 cots["g_rgb"]])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _compare(_leaf_grads(leaves, "pair"), got, keep | True,
             label="1M Function vs kernel")


def _geometry_case(dev):
    """tests/test_torch_port_geometry_reference.py's scene on `dev`: 2,000
    Gaussians in 2,560 slots, SH 3, two cameras at 96x64 and their
    targets."""
    from langsplatv2_tpu_torch.models.gaussians import GaussianModel
    from portbench import common
    from portbench.entries.geometry_step import padded

    cfg = {**common.load_json(common.HERE / "configs" / "lerf_rgb_1m.json"),
           "n_gaussians": 2000,
           "scene": dict(xy_range=[-1.5, 1.5], z_range=[2.0, 5.0],
                         scale_range=[0.01, 0.08],
                         opacity_range=[0.2, 0.95], sh_rest_scale=0.1)}
    scene_ = common.make_scene(cfg, 11, dev)
    model = GaussianModel(**padded(scene_, 2560), active_sh_degree=3,
                          max_sh_degree=3, spatial_lr_scale=1.5)
    g = torch.Generator(dev).manual_seed(11)
    cams = [common.Camera(common.camera(yaw, [0.1 * yaw, -0.05, 0.02], 96,
                                        64, cfg)) for yaw in (-5.0, 4.0)]
    gts = [torch.rand((3, 64, 96), generator=g, device=dev) for _ in cams]
    return cfg, model, cams, gts


def _steps(cfg, model, cams, gts, n_steps, dev):
    """n_steps of rgb_step: (losses, each step's gradients, counter
    growth a step)."""
    import types

    from langsplatv2_tpu_torch.models.renderer import make_settings
    from langsplatv2_tpu_torch.train import trainer

    lr = cfg["lr"]
    opt = types.SimpleNamespace(
        position_lr_init=lr["position_init"],
        position_lr_final=lr["position_final"],
        position_lr_delay_mult=lr["position_delay_mult"],
        position_lr_max_steps=lr["position_max_steps"],
        feature_lr=lr["feature"], opacity_lr=lr["opacity"],
        scaling_lr=lr["scaling"], rotation_lr=lr["rotation"])
    optimizer = trainer.make_rgb_optimizer(opt, model)
    losses, grads, counts = [], [], []
    for i in range(n_steps):
        c = cams[i % 2]
        view, proj, campos, bg = trainer.camera_arrays(c, (0, 0, 0))
        before = _grad_counts()
        m = trainer.rgb_step(make_settings(c, 3, max_entries=2 ** 16),
                             optimizer, cfg["lambda_dssim"], model, view,
                             proj, campos, bg, gts[i % 2], device=dev)
        counts.append({k: v - before[k] for k, v in _grad_counts().items()})
        losses.append(float(m["loss"]))
        grads.append({k: getattr(model, k).grad.clone()
                      for k in trainer.RGB_PARAM_NAMES})
    return losses, grads, counts


def test_card_rgb_steps_on_both_routes(cuda, monkeypatch):
    """Three rgb_steps from the same state on the Function's route and on
    the plain route: one forward and one backward launch and no plain
    call a step on the first, equal losses (the forward is bit-equal;
    the steps after the first differ by Adam's updates of gradients
    equal to summation order), gradients within 1e-5 of each leaf's
    largest."""
    cfg, model, cams, gts = _geometry_case(cuda)
    got = _steps(cfg, model, cams, gts, 3, cuda)
    cfg, model, cams, gts = _geometry_case(cuda)
    monkeypatch.setattr(projection, "preprocess_grad",
                        projection.preprocess_plain)
    want = _steps(cfg, model, cams, gts, 3, cuda)
    for c in got[2]:
        assert c == {"preprocess.launches": 1,
                     "preprocess.grad_launches": 1,
                     "preprocess.plain_calls": 0}, c
    assert got[0][0] == want[0][0]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    live = model.live
    for step_got, step_want in zip(got[1], want[1]):
        for k in step_want:
            a, b = step_got[k][live], step_want[k][live]
            scale = float(b.abs().max())
            assert float((a - b).abs().max()) <= TOL * max(scale, 1e-30), k
