"""The top-k codes (utils/sparse_codes.py): csrc/topk_codes.cu
(ops/topk_codes.py) against the plain path on the card, and on the CPU the routing and the plain path's
contract that the kernel keeps.

The card tests skip without a CUDA device. This file imports neither jax
nor the JAX package (tests/test_torch_port_model.py and
tests/test_torch_port_train.py hold the plain path to JAX), so it also
runs on a machine that has only torch:

    python -m pytest --noconftest tests/test_torch_port_topk_codes.py -q
"""
import re

import numpy as np
import pytest
import torch

from langsplatv2_tpu_torch import tracing
from langsplatv2_tpu_torch.models.gaussians import from_numpy_params
from langsplatv2_tpu_torch.ops import kernels
from langsplatv2_tpu_torch.ops import topk_codes as tk
from langsplatv2_tpu_torch.utils import sparse_codes as sc

from torch_port_fixtures import model_fields

LAUNCHES = "topk_codes.launches"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _launches() -> int:
    return tracing.counters().get(LAUNCHES, 0)


def _logits(n: int, width: int, kind: str, seed: int = 0) -> np.ndarray:
    """[n, width] logits: "normal", "ties" (a few levels, so most rows tie
    across the top-k boundary) or "inf" (rows of all -inf, of two finite
    values among -inf, high and in the lowest columns, with +inf entries,
    of -0 and +0, among normal rows)."""
    rng = np.random.default_rng(seed)
    if kind == "ties":
        return np.round(rng.normal(size=(n, width)) * 1.5).astype(np.float32)
    x = rng.normal(size=(n, width)).astype(np.float32)
    if kind == "inf":
        x[0::7] = -np.inf
        x[1::7] = -np.inf
        x[1::7, 2] = 5.0
        x[1::7, width - 1] = 3.0
        x[2::7, 1] = np.inf
        x[2::7, width - 2] = np.inf
        x[3::7] = 0.0
        x[3::7, ::2] = -0.0
        x[4::7, ::3] = -np.inf
        x[5::7] = -np.inf
        x[5::7, 0] = 5.0
        x[5::7, 1] = 3.0
    return x


def _ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """The largest distance in float32 steps between a and b, both >= 0 or
    NaN at the same places (a NaN pair counts 0)."""
    nan = torch.isnan(a)
    assert torch.equal(nan, torch.isnan(b))
    d = (a.view(torch.int32).long() - b.view(torch.int32).long()).abs()
    return int(torch.where(nan, 0, d).max()) if d.numel() else 0


# ------------------------------------------------------------ on the CPU

def test_cpu_takes_the_plain_path(monkeypatch):
    """CPU logits go to the plain path, never to the kernel, and the
    counter does not move; the model's codes are the plain path's over
    all its levels."""
    def refuse(*_a, **_k):
        raise AssertionError("the kernel path ran on CPU tensors")

    monkeypatch.setattr(tk, "topk_codes_kernel", refuse)
    monkeypatch.setattr(tk, "topk_codes_backward_kernel", refuse)
    f = model_fields(50, seed=3, levels=3, k=16, dim=8)
    f["language_logits"] = _logits(50, 48, "ties", seed=3)
    model = from_numpy_params(f, device="cpu")
    model.language_logits.requires_grad_(True)
    before = _launches()
    w, idx = model.get_weights_and_indices(4)
    w.sum().backward()
    assert _launches() == before
    ref_w, ref_i = sc.get_weights_and_indices_plain(
        model.language_logits.detach(), 4, levels=3)
    assert torch.equal(idx, ref_i) and torch.equal(w, ref_w)
    assert idx.shape == (50, 12) and idx.dtype == torch.int64
    for lvl in range(3):
        cols = idx[:, 4 * lvl:4 * lvl + 4]
        assert bool(((cols >= 16 * lvl) & (cols < 16 * lvl + 16)).all())


def test_plain_path_lowest_index_on_ties():
    """Equal logits across the top-k boundary: the lowest indices win, in
    ascending order, with equal weights."""
    x = torch.zeros(3, 8)
    x[0, [1, 4, 6]] = 2.0          # three tie for the last two places
    x[0, 7] = 3.0
    x[1] = 1.0                     # all equal
    x[2, [0, 5]] = -0.0            # -0 ties +0
    x[2, 3] = 1.0
    w, idx = sc.get_weights_and_indices_plain(x, 3)
    assert idx.tolist() == [[1, 4, 7], [0, 1, 2], [0, 1, 3]]
    assert torch.equal(w[1], torch.full((3,), w[1, 0].item()))
    assert w[0, 0] == w[0, 1] and w[0, 2] > w[0, 0]


def test_plain_path_inf_rows_repeat_indices():
    """A row with fewer than k finite logits takes, once those are gone,
    the lowest index again and again (the masked -inf ties every column):
    the repeats keep their logit in the softmax and their gradients sum; a
    row of all -inf repeats index 0 and its weights are NaN."""
    x = torch.full((3, 8), float("-inf"))
    x[0, 2], x[0, 6] = 5.0, 3.0
    x[2, 0], x[2, 1] = 5.0, 3.0
    x.requires_grad_(True)
    w, idx = sc.get_weights_and_indices_plain(x, 4)
    assert idx.tolist() == [[0, 0, 2, 6], [0, 0, 0, 0], [0, 0, 0, 1]]
    assert bool(torch.isnan(w[1]).all())
    r = torch.tensor([[0.5, -1.0, 2.0, 0.25], [0.0] * 4, [1.5, -0.5, 0.75,
                                                         -2.0]])
    (w[[0, 2]] * r[[0, 2]]).sum().backward()
    for row, picked in ((0, [-float("inf"), -float("inf"), 5.0, 3.0]),
                        (2, [5.0, 5.0, 5.0, 3.0])):
        y = torch.tensor(picked, requires_grad=True)
        ref = torch.softmax(y, 0)
        torch.testing.assert_close(w[row], ref)
        (ref * r[row]).sum().backward()
        want = torch.zeros(8).index_add_(0, idx[row], y.grad)
        torch.testing.assert_close(x.grad[row], want)
    assert torch.count_nonzero(x.grad[0]).item() == 2
    assert torch.count_nonzero(x.grad[2]).item() == 2


@pytest.mark.parametrize("shape,k,levels,dtype,err,match", [
    ((4, 64), 17, 1, torch.float32, ValueError, "outside 1..min"),
    ((4, 6), 7, 1, torch.float32, ValueError, "outside 1..min"),
    ((4, 64), 0, 1, torch.float32, ValueError, "outside 1..min"),
    ((4, 64), 4, 3, torch.float32, ValueError, "levels = 3"),
    ((64,), 4, 1, torch.float32, ValueError, "levels = 1"),
    ((4, 64), 4, 1, torch.float64, TypeError, "float32"),
])
def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(
        shape, k, levels, dtype, err, match):
    """k past MAX_TOPK or K, a width that the levels do not divide, logits
    that are not [N, L*K] and a dtype other than float32 raise before any
    launch."""
    with pytest.raises(err, match=match):
        tk.topk_codes_kernel(torch.zeros(shape, dtype=dtype), k, levels)


def test_max_topk_is_the_kernels():
    """MAX_TOPK is the bound csrc/topk_codes.cu checks and its largest
    instantiation."""
    src = (kernels.CSRC / "topk_codes.cu").read_text()
    assert f"k > {tk.MAX_TOPK} ||" in src
    assert re.findall(r"kernel_of<(\d+)>", src)[-1] == str(tk.MAX_TOPK)
    assert "topk_codes.cu" in kernels.SOURCES


# ------------------------------------------------------------ on the card

# (N, levels, K, k, logits): 1M rows at the feature cell's shape, three
# levels, k = 1, 8, 16, K not a multiple of 4 (37), the widest group (300:
# 32 lanes, some chunks past K), K past the 512 columns 32 lanes hold in
# registers (600 and 601: the streamed columns, 16-byte and single loads),
# odd N.
MATCH_CASES = [(1_000_000, 1, 64, 4, "normal")] + [
    (n, levels, K, k, kind)
    for n, levels, K, k in ((20_001, 3, 64, 4), (4_097, 1, 64, 1),
                            (4_097, 1, 64, 8), (3_001, 2, 32, 16),
                            (2_049, 1, 37, 5), (2_049, 1, 300, 4),
                            (1_025, 1, 600, 4), (1_025, 1, 601, 16),
                            (1_001, 1, 8, 8))
    for kind in ("normal", "ties", "inf")]


@pytest.mark.parametrize("n,levels,K,k,kind", MATCH_CASES)
def test_kernel_matches_plain(cuda, n, levels, K, k, kind):
    """Indices bit for bit, weights within 2 float32 steps, against the
    plain path on the same CUDA logits."""
    x = torch.as_tensor(_logits(n, levels * K, kind, seed=n + k), device=cuda)
    w, idx = tk.topk_codes_kernel(x, k, levels)
    ref_w, ref_i = sc.get_weights_and_indices_plain(x, k, levels)
    assert idx.dtype == torch.int64 and w.dtype == torch.float32
    assert torch.equal(idx, ref_i)
    assert _ulps(w, ref_w) <= 2


@pytest.mark.parametrize("levels,K,k", [(1, 64, 4), (3, 64, 4), (1, 64, 8),
                                        (1, 37, 5), (1, 600, 4),
                                        (1, 601, 16)])
@pytest.mark.parametrize("kind", ["normal", "ties", "inf"])
def test_kernel_backward_matches_autograd(cuda, levels, K, k, kind):
    """d(logits) against autograd through the plain path within 1e-6 of
    the largest, repeated indices summed; exactly 0 in every column no
    index selected (the NaN rows of all -inf left out)."""
    n = 5_003
    x0 = torch.as_tensor(_logits(n, levels * K, kind, seed=k), device=cuda)
    r = torch.randn(n, levels * k, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(k))
    grads = []
    for fn in (sc.get_weights_and_indices, sc.get_weights_and_indices_plain):
        x = x0.clone().requires_grad_(True)
        w, idx = fn(x, k, levels)
        torch.where(torch.isnan(w), 0.0, w * r).sum().backward()
        grads.append(x.grad)
    got, ref = grads
    finite = torch.isfinite(ref).all(dim=1)
    assert int(finite.sum()) > n // 4
    got, ref, idx = got[finite], ref[finite], idx[finite]
    torch.testing.assert_close(got, ref, rtol=1e-6,
                               atol=1e-6 * float(ref.abs().max()))
    selected = torch.zeros_like(got, dtype=torch.bool).scatter_(1, idx, True)
    assert float(got[~selected].abs().max()) == 0.0
    assert bool((got[selected] != 0).any())


def test_training_step_launches_and_no_plain_path(cuda, monkeypatch):
    """A training step's codes (the model's get_weights_and_indices, its
    backward) launch the kernel once forward and once backward, never
    `_topk_columns`, and synchronise nothing; the gradient is a fresh
    tensor the logits' .grad takes."""
    def refuse(*_a, **_k):
        raise AssertionError("_topk_columns ran on CUDA tensors")

    f = model_fields(30_000, seed=1, levels=3, k=64, dim=8)
    f["language_logits"] = _logits(30_000, 192, "normal", seed=1)
    model = from_numpy_params(f, device=cuda)
    logits = model.language_logits.requires_grad_(True)
    ref_w, ref_i = sc.get_weights_and_indices_plain(logits.detach(), 4, 3)
    monkeypatch.setattr(sc, "_topk_columns", refuse)
    torch.cuda.synchronize()
    before = _launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        w, idx = model.get_weights_and_indices(4)
        mid = _launches()
        (w * w).sum().backward()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert (mid - before, _launches() - mid) == (1, 1)
    assert torch.equal(idx, ref_i) and _ulps(w.detach(), ref_w) <= 2
    assert logits.grad is not None and logits.grad.shape == (30_000, 192)
