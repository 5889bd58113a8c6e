"""The traffic generator: equal seeds give equal inputs, other seeds other
inputs of the same sizes; the trainer's order visits every view once an
epoch."""
import random

import numpy as np
import pytest
import torch

from portbench import common, traffic

BIG = 2 ** 31 + 977          # run seeds may pass 32 signed bits


def _mix(name: str, **small) -> tuple:
    bench = common.benchmark()
    w = next(w for w in bench["workloads"] if w["traffic"] == name)
    _w, cfg, mix, _spec = common.cell(w["name"])
    return cfg, {**mix, **small}


SMALL = {"orbit_1080p": dict(width=64, height=48),
         "eval_986": dict(width=64, height=48, views=9),
         "gram_544x960": dict(width=64, height=48, views=4,
                              segments=[5, 9])}


def _flat(t: dict) -> list:
    out = [np.stack([c["view"] for c in t["cameras"]])]
    for key in ("prompts", "tables", "segments"):
        out += [x.numpy() for x in t.get(key, [])]
    if "negatives" in t:
        out.append(t["negatives"].numpy())
    return out


@pytest.mark.parametrize("name", sorted(SMALL))
def test_same_seed_same_inputs(name):
    cfg, mix = _mix(name, **SMALL[name])
    a = traffic.generate(mix, cfg, BIG, torch.device("cpu"))
    b = traffic.generate(mix, cfg, BIG, torch.device("cpu"))
    for x, y in zip(_flat(a), _flat(b), strict=True):
        np.testing.assert_array_equal(x, y)
    assert [a["order"](k) for k in range(20)] == \
        [b["order"](k) for k in range(20)]


@pytest.mark.parametrize("name", sorted(SMALL))
def test_other_seed_same_work_other_values_and_order(name):
    """A seed changes the values and the order, not the poses or sizes."""
    cfg, mix = _mix(name, **SMALL[name])
    a = traffic.generate(mix, cfg, BIG, torch.device("cpu"))
    b = traffic.generate(mix, cfg, 12346, torch.device("cpu"))
    fa, fb = _flat(a), _flat(b)
    np.testing.assert_array_equal(fa[0], fb[0])
    assert any(not np.array_equal(x, y) for x, y in zip(fa[1:], fb[1:]))
    for key in ("prompts", "tables", "segments"):
        for x, y in zip(a.get(key, []), b.get(key, [])):
            assert x.shape == y.shape
    n = mix["views"]
    oa = [a["order"](k) for k in range(2 * n)]
    ob = [b["order"](k) for k in range(2 * n)]
    assert oa != ob and sorted(oa[:n]) == sorted(ob[:n]) == list(range(n))


def test_positive_counts_spread_over_range():
    cfg, mix = _mix("eval_986")
    counts = traffic.spread(*mix["positives"], mix["views"],
                            np.random.default_rng(0))
    assert counts.min() == 4 and counts.max() == 12
    assert sorted(np.bincount(counts)[4:].tolist())[0] >= 7


def test_trainer_order_is_the_trainers():
    order = traffic.make_order("trainer", 5, BIG)
    rng, stack, want = random.Random(BIG), [], []
    for _ in range(15):
        if not stack:
            stack.extend(range(5))
        want.append(stack.pop(rng.randint(0, len(stack) - 1)))
    got = [order(k) for k in range(15)]
    assert got == want
    for e in range(3):
        assert sorted(got[5 * e:5 * e + 5]) == list(range(5))


def test_segments_leave_about_the_unlabelled_share():
    g = common.generator(BIG, "cpu", 4)
    seg = traffic.voronoi_segments(96, 128, 150, 0.05, g, "cpu")
    share = float((seg < 0).float().mean())
    assert 0.05 <= share < 0.12
    assert int(seg.max()) < 150
