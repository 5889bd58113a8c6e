"""K1's `with_alpha` mode and the round-4 lm-payload budget chain, port
against JAX.

K1 with_alpha  langsplatv2_tpu_torch/ops/expand.py::expand_entries
               vs pallas_binning.expand_entries_pallas(with_alpha=s)
lm words       ops/budget.py::pack_lm_words / unpack_lm_words
budget counts  ops/budget.py::budget_counts / budget_counts_windowed
sort payload   ops/expand.py::sort_entries(payload=...) vs
               sorted_binning_from_keys(extra=...)
The JAX kernel runs in interpret mode on the CPU; the port runs K1's plain
version (CPU tensors). The counts are integers and must be equal.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from langsplatv2_tpu.ops import pallas_binning, projection
from langsplatv2_tpu_torch.ops import budget, expand
from langsplatv2_tpu_torch.ops.projection import ProjectedGaussians

from torch_port_fixtures import camera, scene

H, W = 64, 96
GX, GY = -(-W // 16), -(-H // 16)
MAX_ENTRIES = 2 ** 12
CAP = 128


def _u32(words):
    return np.stack([w.numpy().view(np.uint32) for w in words])


@pytest.fixture(scope="module")
def proj_case():
    """300 splats at 64x96: large rects that cross tile corners."""
    sc = scene(300, seed=7)
    view, pm, tfx, tfy = camera(H, W)
    ops = sc["opacities"][:, 0]
    proj = projection.preprocess(
        jnp.asarray(sc["means"]), jnp.asarray(sc["scales"]),
        jnp.asarray(sc["rotations"]), None, None, jnp.asarray(sc["colors"]),
        jnp.asarray(view), jnp.asarray(pm), jnp.zeros(3, jnp.float32),
        tfx, tfy, W, H, 0, 1.0, opacities=jnp.asarray(ops))
    proj_t = ProjectedGaussians(*[
        None if a is None else torch.from_numpy(np.array(a)) for a in proj])
    return proj, proj_t, ops


@pytest.mark.parametrize("subdiv", [2, 4])
def test_with_alpha_chain_matches_pallas(proj_case, subdiv):
    """Entries equal, lm within 1e-5 relative (see below), words equal
    (s = 4 packs 16 sub-boxes into 4 words); then the sort carrying the
    words and both budget counts equal to JAX's on the sorted words."""
    proj, proj_t, ops = proj_case
    out_j = pallas_binning.expand_entries_pallas(
        proj, GX, GY, MAX_ENTRIES, opacities=jnp.asarray(ops),
        exact_cull=True, with_alpha=subdiv, interpret=True)
    tile_j, depth_j, gauss_j, total_j = out_j[:4]
    lms_j = [np.asarray(a) for a in out_j[4:]]
    tile, depth, gauss, total, lm = expand.expand_entries(
        proj_t, torch.from_numpy(ops), GX, GY, MAX_ENTRIES,
        with_alpha=subdiv)
    assert int(total) == int(total_j) < MAX_ENTRIES
    for a, b in ((tile, tile_j), (depth, depth_j), (gauss, gauss_j)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert lm.shape == (subdiv * subdiv, MAX_ENTRIES)
    lm_j = np.stack(lms_j)
    # lm = log1p(-op exp(-q/2)): one f32 ulp of q moves it by up to q/2
    # (~87 before exp underflows) ulps, and XLA:CPU contracts the conic's
    # products differently by context, so JAX's own jit and interpret forms
    # of this expression sit up to ~11 ulps apart. Hence 1e-5 relative
    # (one ulp of q at q <= 174, plus the exp and log1p ulps), with an
    # absolute floor for exp's f32 denormals.
    err = np.abs(lm.numpy() - lm_j)
    assert (err <= 1e-5 * np.abs(lm_j) + 1e-37).all(), float(
        (err / (np.abs(lm_j) + 1e-37)).max())
    live = tile.numpy() < GX * GY
    assert (lm_j[:, live] < 0).any() and (lm_j[:, ~live] == 0).all()

    words = budget.pack_lm_words(lm)
    words_j = pallas_binning.pack_lm_words(tuple(jnp.asarray(a)
                                                 for a in lms_j))
    assert len(words) == len(words_j) == -(-subdiv * subdiv // 4)
    flips = int((_u32(words) != np.stack([np.asarray(w)
                                          for w in words_j])).sum())
    assert flips == 0, f"{flips} words differ (a quantum flipped)"

    num_tiles = GX * GY
    g_s, start, count, (w_sorted) = expand.sort_entries(
        tile, depth, gauss, num_tiles, payload=words)
    keys = pallas_binning.pack_sort_keys(tile_j, depth_j, gauss_j, num_tiles)
    g_j, start_j, count_j, _, w_sorted_j = \
        pallas_binning.sorted_binning_from_keys(keys, num_tiles,
                                                extra=words_j)
    np.testing.assert_array_equal(count.numpy(), np.asarray(count_j))
    live_n = int(count.sum())
    np.testing.assert_array_equal(
        _u32(w_sorted)[:, :live_n],
        np.stack([np.asarray(w) for w in w_sorted_j])[:, :live_n])
    n_box = subdiv * subdiv
    lm_s = budget.unpack_lm_words(w_sorted, n_box)
    np.testing.assert_array_equal(
        lm_s.numpy(), np.asarray(pallas_binning.unpack_lm_words(
            w_sorted_j, n_box)))
    cap = 64                          # below the largest tiles' counts
    assert int(count.max()) > cap
    for t_budget in (1e-6, 1e-2, 0.3):
        kept_all = budget.budget_counts(lm_s, start, count, t_budget)
        kept_all_j = pallas_binning.budget_counts(
            jnp.asarray(lm_s.numpy()), start_j, count_j, t_budget)
        np.testing.assert_array_equal(kept_all.numpy(),
                                      np.asarray(kept_all_j))
        win = tuple(budget.slice_windows(w, start, cap) for w in w_sorted)
        kept, sat = budget.budget_counts_windowed(win, count, cap, n_box,
                                                  t_budget)
        assert torch.equal(kept, torch.clamp(kept_all, max=cap))
        win_j = tuple(pallas_binning.slice_windows(w, start_j, cap)
                      for w in w_sorted_j)
        kept_j, sat_j = pallas_binning.budget_counts_windowed(
            win_j, count_j, cap, n_box, t_budget)
        np.testing.assert_array_equal(kept.numpy(), np.asarray(kept_j))
        np.testing.assert_array_equal(sat.numpy(), np.asarray(sat_j))
    assert int(kept_all.sum()) < live_n, "budget 0.3 should cut entries"


def _word_case(seed):
    """Random sorted words over 40 tiles: quanta from a small set (ties),
    tiles of count 0, 1 and > CAP, and a trailing dead pad of zero words."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 60, 40)
    counts[[3, 17, 30]] = 0
    counts[[5, 22]] = 1
    counts[[9, 33]] = [300, 2 * CAP + 7]
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    e_live = int(counts.sum())
    quanta = rng.choice(np.array([0, 0, 1, 2, 5, 17, 60, 255]),
                        (2, e_live + 50, 4))
    quanta[:, e_live:] = 0                                 # dead pad
    words = (quanta.astype(np.uint64)
             << (8 * np.arange(4, dtype=np.uint64))).sum(-1).astype(np.uint32)
    return words, starts.astype(np.int32), counts.astype(np.int32)


@pytest.mark.parametrize("t_budget", [1e-2, 1e-6])
@pytest.mark.parametrize("n_box", [4, 7])
def test_budget_counts_match_jax(t_budget, n_box):
    """unpack_lm_words, budget_counts and budget_counts_windowed equal to
    JAX's on random words with ties; the windowed counts equal
    min(budget_counts, cap) on every tile (JAX's own claim)."""
    words_np, starts, counts = _word_case(int(t_budget < 1e-3) + n_box)
    words_np = words_np[:-(-n_box // 4)]
    words = tuple(torch.from_numpy(w.view(np.int32)) for w in words_np)
    words_j = tuple(jnp.asarray(w) for w in words_np)
    lm = budget.unpack_lm_words(words, n_box)
    lm_j = pallas_binning.unpack_lm_words(words_j, n_box)
    np.testing.assert_array_equal(lm.numpy(), np.asarray(lm_j))
    np.testing.assert_array_equal(_u32(budget.pack_lm_words(lm.T)),
                                  np.stack([np.asarray(w) for w in
                                            pallas_binning.pack_lm_words(
                                                tuple(lm_j.T))]))
    start_t, count_t = torch.from_numpy(starts), torch.from_numpy(counts)
    kept_all = budget.budget_counts(lm, start_t, count_t, t_budget)
    kept_all_j = pallas_binning.budget_counts(lm_j, jnp.asarray(starts),
                                              jnp.asarray(counts), t_budget)
    np.testing.assert_array_equal(kept_all.numpy(), np.asarray(kept_all_j))
    assert (kept_all.numpy()[counts == 0] == 0).all()
    assert (kept_all.numpy()[counts > 0] >= 1).all()
    win = tuple(budget.slice_windows(w, start_t, CAP) for w in words)
    win_j = tuple(pallas_binning.slice_windows(w, jnp.asarray(starts), CAP)
                  for w in words_j)
    kept, sat = budget.budget_counts_windowed(win, count_t, CAP, n_box,
                                              t_budget)
    kept_j, sat_j = pallas_binning.budget_counts_windowed(
        win_j, jnp.asarray(counts), CAP, n_box, t_budget)
    np.testing.assert_array_equal(kept.numpy(), np.asarray(kept_j))
    np.testing.assert_array_equal(sat.numpy(), np.asarray(sat_j))
    assert torch.equal(kept, torch.clamp(kept_all, max=CAP))


def test_with_alpha_needs_exact_cull(proj_case):
    _, proj_t, ops = proj_case
    with pytest.raises(ValueError, match="exact_cull"):
        expand.expand_entries(proj_t, torch.from_numpy(ops), GX, GY,
                              MAX_ENTRIES, exact_cull=False, with_alpha=2)
    with pytest.raises(ValueError, match="divide"):
        expand.expand_entries(proj_t, torch.from_numpy(ops), GX, GY,
                              MAX_ENTRIES, with_alpha=3)
