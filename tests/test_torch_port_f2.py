"""The shapes past the main path's kernel designs, on the CPU: K3 and K2q's
query at any L, K and PQ, K6a and K6b at any M and K (JAX's Pallas kernels
take them all).

- `query.kernel_plan` and `gram.kernel_plan`, pure functions of the shapes
  that the CUDA wrappers launch by, cover a grid of shapes without raising:
  K in {8, 20, 32, 64, 96}, L in {1, 3, 4}, PQ in {1, 16, 17, 33}, and
  M = (lay + 1) K up to 256 (and 320, past the widest shared stage).
- The plain versions run through the plans (K padded to the mma k-step with
  zeros, a level's [gram | phi] n-tiles in chunks, the levels in turn; G's
  output columns reordered with layer lay's block last, blocks of at most 64
  columns, d_G in row blocks) equal the unplanned plain versions: exactly
  where the plan only adds zeros (products on padded columns are exactly 0
  and the real ones unchanged), within 1e-6 of the largest entry where it
  regroups sums.
- On maps of 2 tiles the plain versions equal JAX's Pallas kernels in
  interpret mode at PQ = 17, K = 32, L = 4 (`query_map_tiles`, f32 and bf16
  map) and at K = 32, M = 256 (`_gram_fwd_pallas`, `_gram_bwd_pallas`),
  within the CPU limits of tests/test_torch_port_query_gram.py (the query
  rtol/atol 1e-5; the Gram gradients 5e-6 of their largest entry; the
  forward sum rtol 1e-5).

Inputs come from numpy seeds. tests/test_torch_port_gpu.py holds the CUDA
kernels to these plain versions at the same shapes on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from langsplatv2_tpu.ops.pallas_gram import _gram_bwd_pallas, \
    _gram_fwd_pallas
from langsplatv2_tpu.ops.pallas_query import query_map_tiles as jax_query
from langsplatv2_tpu_torch.ops import gram, query

from torch_port_fixtures import gram_pattern_case

GRID_K = (8, 20, 32, 64, 96)
GRID_L = (1, 3, 4)
GRID_PQ = (1, 16, 17, 33)


# ------------------------------------------------------------------ plans
@pytest.mark.parametrize("k", GRID_K)
def test_query_plan_covers_the_grid(k):
    """Every (L, PQ, map type) at this K has a plan: the main design only
    at K = 64, L <= 3, PQ <= 16; K padded to the k-step; the chunks tile
    the level's n-tiles in order, at most 4 each; the prompt chunks tile
    [0, PQ) in order; the fragments fit the scratch."""
    for L in GRID_L:
        for pq in GRID_PQ:
            for bf16 in (False, True):
                p = query.kernel_plan(L, k, pq, bf16)
                assert p["route"] == ("main" if k == 64 and L <= 3
                                      and pq <= 16 else "any")
                step = 16 if bf16 else 8
                assert p["k_step"] == step and p["k_pad"] % step == 0
                assert k <= p["k_pad"] < k + step
                assert p["nt"] == p["k_pad"] // 8 + -(-pq // 8)
                ends = [b for _a, b in p["chunks"]]
                assert [a for a, _b in p["chunks"]] == [0] + ends[:-1]
                assert ends[-1] == p["nt"]
                assert all(0 < b - a <= 4 for a, b in p["chunks"])
                qs = p["pq_chunks"]
                assert qs[0][0] == 0 and qs[-1][1] == pq
                assert all(a < b for a, b in qs)
                assert all(qs[i][1] == qs[i + 1][0]
                           for i in range(len(qs) - 1))
                assert p["levels"] == list(range(L))
                assert p["frag_words"] == L * p["nt"] * (
                    p["k_pad"] // step) * 32 * (2 if bf16 else 4)


def _check_gram_plan(m, k, c):
    p = gram.kernel_plan(m, k, c)
    n_k = -(-m // 64)
    assert p["kpk"] == (n_k if n_k <= 4 else 0) or (
        n_k == 1 and p["kpk"] == 2)
    assert p["any"] == (not (m % 64 == 0 and n_k <= 4 and c % 4 == 0
                             and k in (None, 64)))
    need = 0
    covered = np.zeros(m if k is None else k, int)
    rows = np.zeros(m, int)
    for ps in p["passes"]:
        cols = gram.out_columns(ps)
        assert len(cols) == 64 * ps.n_out and ps.n_k == n_k
        real = [c_ for c_ in cols if c_ >= 0]
        # Every map column once; K6b: layer lay's block last, in order.
        assert sorted(real) == list(range(m))
        if k is not None:
            block = cols[64 * (ps.n_out - 1):][:ps.kb]
            assert block == list(range(ps.c0, ps.c0 + ps.kb))
            assert ps.c0 == m - k + ps.j0 and ps.kb <= 64
            assert all(c_ == -1 for c_ in cols[64 * (ps.n_out - 1):][ps.kb:])
            if ps.dw:
                covered[ps.j0:ps.j0 + ps.kb] += 1
            rows[ps.r0:ps.r0 + (gram.ROW_BLOCK if p["kpk"] == 0
                                else m)] += 1
        if p["kpk"] == 1:
            assert ps.n_out * ps.n_k == 1
        need = max(need, 2 * 64 * 64 * ps.n_out * ps.n_k)
    assert p["gsplit_floats"] == need
    if k is not None:
        # Each layer column's d_w and d_phi once; each d_G row once a block.
        assert (covered == 1).all()
        assert (rows == -(-k // 64)).all()
        assert sum(ps.zero_rest for ps in p["passes"]) == 1
    return p


@pytest.mark.parametrize("k", GRID_K)
def test_gram_plan_covers_the_grid(k):
    """K6a and K6b at every layer of K whose M = (lay + 1) K is at most 256,
    and at M = 320 (past the widest stage: unstaged, d_G in row blocks),
    on a map of M and of M + 5 columns: each pass's output columns hold
    every map column once (K6b: layer lay's block last); the passes write
    each layer column's d_w and d_phi once and accumulate each d_G row
    once a layer block; the scratch fits the largest pass."""
    for m in list(range(k, 257, k)) + [320 // k * k]:
        for c in (m, m + 5):
            for kk in (None, k):
                p = _check_gram_plan(m, kk, c)
                if m > 256:
                    assert p["kpk"] == 0 and p["any"]


# ----------------------------------------------- the plain versions, planned
def _pad_query(wm, phi, gm, kp):
    """The map, phi and gram with K padded to kp with zeros."""
    t, p, _ = wm.shape
    L, K, PQ = phi.shape
    w = torch.zeros(t, p, L, kp)
    w[..., :K] = wm.float().reshape(t, p, L, K)
    ph = torch.zeros(L, kp, PQ)
    ph[:, :K] = phi
    g = torch.zeros(L, kp, kp)
    g[:, :K, :K] = gm
    return w, ph, g


def query_through_plan(wm, phi, gm, plan):
    """The plain query as the general kernel cuts it: K padded, B_l =
    [gram_l | phi_l] in n-tiles of 8, a chunk of n-tiles at a time, nrm2
    summed over the gram chunks, the levels in the plan's order."""
    t, p, _ = wm.shape
    L, K, PQ = phi.shape
    kp = plan["k_pad"]
    w, ph, g = _pad_query(wm, phi, gm, kp)
    w = w.reshape(t * p, L, kp)
    raw = torch.empty(t * p, L, PQ)
    nrm2 = torch.empty(t * p, L)
    for lvl in plan["levels"]:
        b = torch.zeros(kp, 8 * plan["nt"])
        b[:, :kp] = g[lvl]
        b[:, kp:kp + PQ] = ph[lvl]
        n2 = torch.zeros(t * p)
        for a, e in plan["chunks"]:
            d = w[:, lvl] @ b[:, 8 * a:8 * e]
            gcols = max(0, min(8 * e, kp) - 8 * a)
            n2 += (d[:, :gcols] * w[:, lvl, 8 * a:8 * a + gcols]).sum(-1)
            for q0, q1 in plan["pq_chunks"]:
                lo, hi = max(q0, 8 * a - kp), min(q1, 8 * e - kp)
                if lo < hi:
                    raw[:, lvl, lo:hi] = d[:, kp + lo - 8 * a:kp + hi - 8 * a]
        nrm2[:, lvl] = n2
    return raw.reshape(t, p, L * PQ), nrm2.reshape(t, p, L)


def _close_of_largest(a, b, tol):
    scale = max(float(b.abs().max()), 1e-30)
    torch.testing.assert_close(a / scale, b / scale, atol=tol, rtol=0)


@pytest.mark.parametrize("L,K,PQ,bf16", [
    (4, 20, 33, False), (4, 20, 17, True), (3, 64, 17, False),
    (1, 96, 1, True), (4, 32, 33, True), (3, 7, 5, False)])
def test_query_plain_through_the_plan(L, K, PQ, bf16):
    """raw and nrm2 through the plan against the unplanned plain versions:
    padding K adds only zeros (raw exact; the gram products exact, zero on
    the padded columns); the chunked sums within 1e-6 of the largest."""
    rng = np.random.default_rng(L * 100 + K + PQ)
    wm = torch.from_numpy(rng.standard_normal((2, 256, L * K)).astype(
        np.float32))
    phi = torch.from_numpy(rng.standard_normal((L, K, PQ)).astype(np.float32))
    cb = rng.standard_normal((L, K, 16)).astype(np.float32)
    gm = torch.from_numpy(np.einsum("lkd,lmd->lkm", cb, cb).astype(np.float32))
    if bf16:
        wm = wm.to(torch.bfloat16)
        phi, gm = query.round_bf16(phi), query.round_bf16(gm)
    plan = query.kernel_plan(L, K, PQ, bf16)
    want = query.query_map_tiles_plain(wm.float(), phi, gm)
    kp = plan["k_pad"]
    w, ph, g = _pad_query(wm, phi, gm, kp)
    padded = query.query_map_tiles_plain(w.reshape(2, 256, L * kp), ph, g)
    assert torch.equal(padded[0], want[0])
    w0 = wm.float().reshape(-1, L, K)
    for lvl in range(L):
        wg = w.reshape(-1, L, kp)[:, lvl] @ g[lvl]
        assert torch.equal(wg[:, :K], w0[:, lvl] @ gm[lvl])
        assert not wg[:, K:].any()
    _close_of_largest(padded[1], want[1], 1e-6)
    got = query_through_plan(wm, phi, gm, plan)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        _close_of_largest(a, b, 1e-6)


def _gram_inputs(m, k, seed, extra=0):
    case = gram_pattern_case("warp_segments", m, tiles=2, seed=seed, k=k)
    case["seg"][1, ::3] = -1
    rng = np.random.default_rng(seed + 1)
    w = np.concatenate([case["w"], rng.standard_normal(
        (2, 256, extra)).astype(np.float32)], axis=2)
    lay = m // k - 1
    rhs, gfull = gram.prep(torch.from_numpy(case["codebooks"]),
                           torch.from_numpy(case["table"]), lay)
    return torch.from_numpy(case["seg"]), torch.from_numpy(w), rhs, gfull, lay


def _b_matrix(gfull, p):
    """G's padded, reordered B of a pass: [64 n_k, 64 n_out], row i < M and
    output column n of map column out_col(n) >= 0, else 0."""
    m = p.M
    b = torch.zeros(64 * p.n_k, 64 * p.n_out)
    for n, col in enumerate(gram.out_columns(p)):
        if col >= 0:
            b[:m, n] = gfull[:, col]
    return b


def _chain_through_pass(seg, w, rhs, gfull, p):
    """Stage (1) of a pass: W (padded to the k-panels) . B a 64-column panel
    at a time, n2 and num summed panel by panel over the real columns; the
    last panel's products."""
    q = seg.numel()
    m = p.M
    wf = w.reshape(q, -1)
    wpad = torch.zeros(q, 64 * p.n_k)
    wpad[:, :m] = wf[:, :m]
    valid = seg.reshape(-1) >= 0
    looked = torch.where(valid[:, None], rhs[seg.reshape(-1).clamp(min=0)
                                             .long()], 0.0)
    b = _b_matrix(gfull, p)
    cols = gram.out_columns(p)
    n2 = torch.zeros(q)
    num = torch.zeros(q)
    for panel in range(p.n_out):
        wg = wpad @ b[:, 64 * panel:64 * panel + 64]
        idx = [i for i in range(64) if cols[64 * panel + i] >= 0]
        mc = [cols[64 * panel + i] for i in idx]
        n2 += (wg[:, idx] * wf[:, mc]).sum(-1)
        num += (wf[:, mc] * looked[:, mc]).sum(-1)
    return wf, looked, n2, num, wg


def gram_fwd_through_plan(seg, w, rhs, gfull, eps, plan):
    """K6a's sums as its plan cuts them: per pixel through the pass, then
    each 128-pixel chunk summed, the two chunks of a tile added."""
    (p,) = plan["passes"]
    _wf, looked, n2, num, _ = _chain_through_pass(seg, w, rhs, gfull, p)
    covered = n2 > 0
    nrm = torch.where(covered, torch.sqrt(torch.where(covered, n2, 1.0)), 0.0)
    sim = num / (nrm.clamp(min=eps) * looked[:, p.M].clamp(min=eps))
    halves = sim.reshape(-1, 128).sum(-1).reshape(-1, 2)
    return halves[:, 0] + halves[:, 1]


def gram_bwd_through_plan(seg, w, rhs, gfull, lay, k, eps, inv_hw,
                          upstream, plan):
    """K6b's gradients pass by pass: d_w of the pass's layer block from the
    last panel's products, zeros outside the layer from the first pass,
    d_phi of the block, d_G's row block."""
    t, _, c = w.shape
    m = gfull.shape[0]
    dw = torch.full((t * 256, c), float("nan"))
    dphi = torch.zeros(rhs.shape[0], k)
    dg = torch.zeros(m, k)
    segf = seg.reshape(-1)
    valid = segf >= 0
    for p in plan["passes"]:
        wf, looked, n2, num, wg = _chain_through_pass(seg, w, rhs, gfull, p)
        covered = n2 > 0
        n2g = torch.where(covered, n2, 1.0)
        nrm = torch.where(covered, torch.sqrt(n2g), 0.0)
        a = nrm.clamp(min=eps)
        b = looked[:, m].clamp(min=eps)
        d_sim = -inv_hw * upstream
        inv_ab = 1.0 / (a * b)
        d_num = d_sim * inv_ab
        d_a = -d_sim * num * inv_ab / a
        dmax = torch.where(nrm > eps, 1.0, torch.where(nrm == eps, 0.5, 0.0))
        d_n2 = torch.where(covered, d_a * dmax * 0.5 / torch.sqrt(n2g), 0.0)
        blk = slice(p.c0, p.c0 + p.kb)
        if p.zero_rest:
            dw[:, :] = 0.0
        if p.dw:
            dw[:, blk] = (d_num[:, None] * looked[:, blk]
                          + 2.0 * d_n2[:, None] * wg[:, :p.kb])
            dphi[:, p.j0:p.j0 + p.kb].index_add_(
                0, segf[valid].long(), (d_num[:, None] * wf[:, blk])[valid])
        r1 = m if plan["kpk"] else min(m, p.r0 + gram.ROW_BLOCK)
        dg[p.r0:r1, p.j0:p.j0 + p.kb] += wf[:, p.r0:r1].T @ (
            d_n2[:, None] * wf[:, blk])
    return dw.reshape(t, 256, c), dphi, dg


@pytest.mark.parametrize("m,k,extra", [(8, 8, 0), (21, 7, 5), (64, 32, 0),
                                       (96, 32, 3), (192, 96, 0),
                                       (256, 64, 0), (320, 64, 2)])
def test_gram_plain_through_the_plan(m, k, extra):
    """K6a's per-tile sums and K6b's d_w, d_phi, d_G through the plan
    against the unplanned plain versions, within 1e-6 of the largest entry
    (the sums regrouped by panel, chunk and row block); d_w exactly 0
    outside layer lay's columns; padding M to the k-panels adds only zeros
    (the padded rows and columns of W.G's operands give exactly the
    unpadded products)."""
    seg, w, rhs, gfull, lay = _gram_inputs(m, k, m + k, extra)
    c = w.shape[2]
    fwd = gram.kernel_plan(m, None, c)
    want = gram.gram_tiles_fwd_plain(seg, w, rhs, gfull, 1e-8)
    got = gram_fwd_through_plan(seg, w, rhs, gfull, 1e-8, fwd)
    _close_of_largest(got, want, 1e-6)
    (p,) = fwd["passes"]
    wf = w.reshape(-1, c)[:, :m]
    wpad = torch.zeros(wf.shape[0], 64 * p.n_k)
    wpad[:, :m] = wf
    full = wpad @ _b_matrix(gfull, p)
    assert torch.equal(full[:, :m], wf @ gfull)
    assert not full[:, m:].any()

    bwd = gram.kernel_plan(m, k, c)
    up = torch.tensor(1.5)
    args = (seg, w, rhs, gfull, lay, k, 1e-8, 1.0 / seg.numel(), up)
    want = gram.gram_tiles_bwd_plain(*args)
    got = gram_bwd_through_plan(*args, bwd)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        _close_of_largest(a, b, 1e-6)
    keep = torch.zeros(c, dtype=torch.bool)
    keep[m - k:m] = True
    assert not got[0][..., ~keep].any()


# ------------------------------------------------- against JAX's kernels
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_query_plain_matches_pallas_at_f2_shape(bf16):
    """query_map_tiles_plain (bf16 map: query_map_tiles_bf16_plain) against
    pallas_query.query_map_tiles in interpret mode at L = 4, K = 32,
    PQ = 17, 2 tiles; rtol/atol 1e-5."""
    L, K, PQ = 4, 32, 17
    rng = np.random.default_rng(17 + bf16)
    wm = torch.from_numpy(rng.standard_normal((2, 256, L * K)).astype(
        np.float32))
    phi = rng.standard_normal((L, K, PQ)).astype(np.float32)
    cb = rng.standard_normal((L, K, 16)).astype(np.float32)
    gm = np.einsum("lkd,lmd->lkm", cb, cb).astype(np.float32)
    if bf16:
        wm = wm.to(torch.bfloat16)
    raw, nrm2 = query.query_map_tiles(wm, torch.from_numpy(phi),
                                      torch.from_numpy(gm))
    wj = jnp.asarray(wm.float().numpy())
    raw_j, nrm2_j = jax_query(wj.astype(jnp.bfloat16) if bf16 else wj,
                              jnp.asarray(phi), jnp.asarray(gm),
                              tile_batch=2, interpret=True)
    assert raw.shape == (2, 256, L * PQ) and nrm2.shape == (2, 256, L)
    np.testing.assert_allclose(raw.numpy(), np.asarray(raw_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(nrm2.numpy(), np.asarray(nrm2_j), rtol=1e-5,
                               atol=1e-5)


def test_gram_plain_matches_pallas_at_f2_shape():
    """gram_tiles_fwd_plain and gram_tiles_bwd_plain against
    _gram_fwd_pallas / _gram_bwd_pallas in interpret mode at K = 32, M = 256
    (layer 7), 2 tiles of whole-warp segments with -1 holes: the forward
    sum rtol 1e-5, the gradients 5e-6 of their largest entry."""
    m, k = 256, 32
    seg, w, rhs, gfull, lay = _gram_inputs(m, k, 3)
    inv_hw = 1.0 / 512
    total = float(gram.gram_tiles_fwd_plain(seg, w, rhs, gfull, 1e-8).sum())
    args = (jnp.asarray(seg.numpy()), jnp.asarray(w.numpy()),
            jnp.asarray(rhs.numpy()), jnp.asarray(gfull.numpy()))
    want = float(_gram_fwd_pallas(*args, lay=lay, tb=1, eps=1e-8,
                                  interpret=True))
    np.testing.assert_allclose(total, want, rtol=1e-5)
    got = gram.gram_tiles_bwd_plain(seg, w, rhs, gfull, lay, k, 1e-8,
                                    inv_hw, torch.tensor(1.0))
    ref = _gram_bwd_pallas(*args, lay=lay, k_l=k, tb=1, eps=1e-8,
                           inv_hw=inv_hw, interpret=True)
    for a, b in zip(got, ref):
        b = np.asarray(b)
        assert a.shape == b.shape
        sc = max(1e-30, float(np.abs(b).max()))
        np.testing.assert_allclose(a.numpy() / sc, b / sc, atol=5e-6)
