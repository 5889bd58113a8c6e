"""The port's Gaussian-sharded render and feature step
(langsplatv2_tpu_torch/parallel/gauss_sharded.py) against JAX's
rasterize_gauss_sharded and rasterize_gauss_sharded_feature_train on a
4-device "gauss" mesh, jitted.

The port's side runs once per module: four gloo ranks on the CPU
(tests/torch_port_dist_workers.py::gauss_world), each passing its own
quarter of the Gaussians and computing every case. Totals, dropped entries
and radii are integers and must be equal; images agree within 2e-5 (JAX's
test_sharding.py tolerance: the Pallas blend carries T as exp(sum log1p),
the port's K2 as a running product) and d(quick_weights) within 1e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from langsplatv2_tpu.ops import RasterizeSettings as JaxSettings
from langsplatv2_tpu.ops import rasterize as jax_rasterize
from langsplatv2_tpu.parallel import gauss_sharded as jax_gs
from langsplatv2_tpu_torch.parallel import spawn_ranks

import torch_port_dist_workers as workers
from torch_port_fixtures import camera, quick_pairs, scene

C = 4
CAP = 2048


def _case(n: int, h: int, w: int, seed: int, *, quick: bool = True,
          levels: int = 3, k: int = 64, topk: int = 4, **over) -> dict:
    sc = scene(n, seed)
    view, pm, tfx, tfy = camera(h, w)
    case = dict(settings=dict(image_height=h, image_width=w, tanfovx=tfx,
                              tanfovy=tfy, sh_degree=0, max_entries=2 ** 13),
                means3d=sc["means"], opacities=sc["opacities"],
                scales=sc["scales"], rotations=sc["rotations"],
                colors_precomp=sc["colors"], view=view, proj=pm,
                campos=np.zeros(3, np.float32),
                bg=np.array([0.2, 0.3, 0.1], np.float32),
                pair_capacity=CAP)
    if quick:
        qw, qi = quick_pairs(n, levels, k, topk, seed + 7)
        case.update(quick_weights=qw, quick_indices=qi,
                    quick_channels=levels * k)
    case.update(over)
    return case


def _cases() -> dict:
    cases = {
        # 48x64: 12 tiles, 3 a rank.
        "quick": _case(400, 48, 64, 1),
        # 48x72: 15 tiles over 4 strips of 4; slot 15 holds the sentinel.
        "sentinel": _case(400, 48, 72, 2),
        # Every Gaussian at one depth: ties broken by global id.
        "ties": _case(400, 48, 64, 3),
        # Wide splats on the 15-tile grid: pairs overflow 128 slots.
        "overflow": _case(800, 48, 72, 4, quick=False, pair_capacity=128),
    }
    cases["ties"]["means3d"] = cases["ties"]["means3d"].copy()
    cases["ties"]["means3d"][:, 2] = 4.0
    cases["overflow"]["scales"] = np.full((800, 3), 0.6, np.float32)
    sh = _case(400, 48, 64, 5, quick=False, facade=True)
    rng = np.random.default_rng(9)
    shs = rng.normal(size=(400, 4, 3)).astype(np.float32) * 0.3
    shs[:, 0, :] = rng.uniform(0.1, 1.5, (400, 3))
    sh.update(shs=shs, colors_precomp=None, pair_capacity=None)
    sh["settings"].update(sh_degree=1, binning="gauss", pair_capacity=CAP)
    cases["facade_sh"] = sh
    for name, n, w in (("grad", 400, 72), ("grad_jax", 160, 64)):
        grad = _case(n, 48, w, 6, levels=1)
        grad["settings"]["assemble"] = True
        grad["probe"] = np.random.default_rng(11).standard_normal(
            (64, 48, w)).astype(np.float32)
        cases[name] = grad
    return cases


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cases = _cases()
    ranks = spawn_ranks(workers.gauss_world, C, (cases,),
                        store_dir=tmp_path_factory.mktemp("gauss_world"),
                        timeout=300)
    return cases, ranks


def _mesh():
    return Mesh(np.asarray(jax.devices()[:C]), ("gauss",))


def _jax_settings(case, **over):
    s = {k: v for k, v in case["settings"].items()
         if k not in ("binning", "pair_capacity")}
    s.update(over)
    return JaxSettings(**s)


def _jnp(case, *names):
    return [None if case.get(k) is None else jnp.asarray(case[k])
            for k in names]


def _jax_forward(case):
    means, ops, scales, rots, cols, shs, qw, qi = _jnp(
        case, "means3d", "opacities", "scales", "rotations",
        "colors_precomp", "shs", "quick_weights", "quick_indices")
    args = [jnp.asarray(case[k]) for k in ("view", "proj", "campos", "bg")]
    s = _jax_settings(case)
    if case.get("facade"):
        s = s._replace(binning="gauss",
                       pair_capacity=case["settings"]["pair_capacity"])
        out = jax.jit(lambda: jax_rasterize(
            s, means, ops, *args, scales=scales, rotations=rots, shs=shs,
            mesh=_mesh()))()
        return (out.rgb, out.feature_map, out.final_transmittance,
                out.total_entries, out.dropped_entries, out.radii)
    return jax.jit(lambda: jax_gs.rasterize_gauss_sharded(
        _mesh(), s, means, ops, *args, scales=scales, rotations=rots,
        colors_precomp=cols, shs=shs, quick_weights=qw, quick_indices=qi,
        quick_channels=case.get("quick_channels", 192),
        pair_capacity=case["pair_capacity"]))()


@pytest.fixture(scope="module")
def jax_out(world):
    cases, _ = world
    return {name: [np.asarray(x) if x is not None else None
                   for x in _jax_forward(case)]
            for name, case in cases.items() if "probe" not in case}


FORWARD = ("quick", "sentinel", "ties", "overflow", "facade_sh")


@pytest.mark.parametrize("name", FORWARD)
def test_counts_exact(world, jax_out, name):
    """total and dropped summed over the ranks, and each rank's radii,
    equal JAX's."""
    _, ranks = world
    _rgb, _feat, _t, total, dropped, radii = jax_out[name]
    for r in ranks:
        assert r[name]["total"] == int(total)
        assert r[name]["dropped"] == int(dropped)
    np.testing.assert_array_equal(
        np.concatenate([r[name]["radii"] for r in ranks]), radii)


@pytest.mark.parametrize("name", FORWARD)
def test_images_match_jax(world, jax_out, name):
    _, ranks = world
    rgb, feat, t, *_ = jax_out[name]
    for r in ranks:     # every rank holds the gathered images
        out = r[name]
        np.testing.assert_allclose(out["rgb"], rgb, atol=2e-5)
        np.testing.assert_allclose(out["t"], t, atol=2e-5)
        if feat is not None:
            np.testing.assert_allclose(out["feat"], feat, atol=2e-5)
        else:
            assert out["feat"] is None


def test_drops_reported_and_recounted(world, jax_out):
    """A 128-slot capacity drops entries; dropped is the sum of each
    pair's excess over the capacity, from the ranks' segment lengths."""
    _, ranks = world
    dcount = np.stack([r["overflow"]["dcount"] for r in ranks])
    cap = ranks[0]["overflow"]["cap"]
    assert cap == 128
    recount = int(np.maximum(dcount - cap, 0).sum())
    assert recount > 0
    assert ranks[0]["overflow"]["dropped"] == recount == int(
        jax_out["overflow"][4])


def test_sentinel_entries_go_to_the_last_strip(world, jax_out):
    """Where 4 strips of 4 cover 15 tiles, the cull's sentinel entries
    ride in the last rank's segments, as in JAX: what the last rank is
    sent is more than the entries of its tiles, every other rank is sent
    its tiles' entries only, and the segments add up to the total."""
    _, ranks = world
    dcount = np.stack([r["sentinel"]["dcount"] for r in ranks])
    received = [r["sentinel"]["received"] for r in ranks]
    assert dcount.sum() == int(jax_out["sentinel"][3])
    assert list(dcount[:, :-1].sum(0)) == received[:-1]
    assert dcount[:, -1].sum() > received[-1] > 0


def test_facade_route(world):
    """rasterize(binning="gauss", mesh=...) returns max_tile_count 0 and
    no drops at a generous capacity."""
    _, ranks = world
    for r in ranks:
        assert r["facade_sh"]["max_tile_count"] == 0
        assert r["facade_sh"]["dropped"] == 0


def test_feature_grad_equals_single_card(world):
    """d(quick_weights) through the exchange (K4 on the strips, the reverse
    all-to-all, the index_add_ onto the ranks' rows) on the 15-tile grid:
    the ranks' rows stacked equal the port's single-card QuickTrainBlend
    gradient (the same entries summed in the same order), and the summed
    strip losses its loss."""
    import torch
    from langsplatv2_tpu_torch.ops.rasterize import (RasterizeSettings,
                                                     rasterize)

    cases, ranks = world
    case = cases["grad"]
    qw = torch.tensor(case["quick_weights"], requires_grad=True)
    out = rasterize(RasterizeSettings(**case["settings"]), case["means3d"],
                    case["opacities"], case["view"], case["proj"],
                    case["campos"], case["bg"], scales=case["scales"],
                    rotations=case["rotations"],
                    colors_precomp=case["colors_precomp"], quick_weights=qw,
                    quick_indices=case["quick_indices"], quick_channels=64,
                    quick_train=True, device="cpu")
    loss = (out.feature_map * torch.from_numpy(case["probe"])).sum()
    loss.backward()
    d = np.concatenate([r["grad"]["grad"] for r in ranks])
    assert np.abs(d).max() > 0
    np.testing.assert_allclose(d, qw.grad.numpy(), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(sum(r["grad"]["loss"] for r in ranks),
                               float(loss.detach()), rtol=1e-5)
    assert all(r["grad"]["dropped"] == 0 for r in ranks)


def test_feature_grad_matches_jax(world):
    """d(quick_weights) against JAX's rasterize_gauss_sharded_feature_train
    within 1e-4, the summed strip losses against its loss, on the density
    of JAX's own test (160 Gaussians at 48x64). In denser scenes pixels sit
    at the 1e-4 transmittance threshold, where the port's running-product T
    and JAX's exp(sum log1p) end a pixel one entry apart (the documented
    difference of the two blends, test_torch_port_train.py); the port's
    single-card gradient above is the exact check there."""
    cases, ranks = world
    case = cases["grad_jax"]
    means, ops, scales, rots, cols, qw, qi = _jnp(
        case, "means3d", "opacities", "scales", "rotations",
        "colors_precomp", "quick_weights", "quick_indices")
    args = [jnp.asarray(case[k]) for k in ("view", "proj", "campos", "bg")]
    probe = jnp.asarray(case["probe"])
    s = _jax_settings(case)

    def loss(q):
        _, f, *_ = jax_gs.rasterize_gauss_sharded_feature_train(
            _mesh(), s, means, ops, *args, q, qi, 64, scales=scales,
            rotations=rots, colors_precomp=cols,
            pair_capacity=case["pair_capacity"])
        return jnp.sum(f * probe), f

    (l_ref, f_ref), d_ref = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        qw)
    # The loss is a cancelling f32 sum of ~3e3 * 64 terms taken in another
    # order: 1e-5 of the terms' magnitude.
    scale = float(np.abs(np.asarray(f_ref) * case["probe"]).sum())
    assert abs(sum(r["grad_jax"]["loss"] for r in ranks) - float(l_ref)) \
        <= 1e-5 * scale
    d = np.concatenate([r["grad_jax"]["grad"] for r in ranks])
    assert np.abs(d).max() > 0
    np.testing.assert_allclose(d, np.asarray(d_ref), atol=1e-4, rtol=1e-4)
