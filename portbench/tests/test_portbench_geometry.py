"""The geometry cell at a CPU test's size: a whole run is correct and its
traced run reads every geom.* metric, while the control (the reference
in TF32 in the program's place) and each fault planted under the timed
path (the loss over half of each view, no update) come out not correct;
the reference's round and the replay's restore on their own."""
import time

import pytest
import torch

from portbench import common, control, run
from portbench.entries import geometry_step as gs

BIG = 2 ** 31 + 4099
CELL = "lerf_rgb_1m.geometry_544x960"
# 3,000 Gaussians in 16,384 slots (64x48 views make most of them hot, and
# each split adds one), the replay cut to 8 iterations with a round every
# 4, the trace over iterations 3503-3504 (a round).
TINY = {"config": {"n_gaussians": 3000, "capacity": 16384,
                   "replay": {"first": 3501, "last": 3508},
                   "densification_interval": 4},
        "traffic": {"width": 64, "height": 48, "views": 3},
        "cell": {"probe_entries": 1 << 16,
                 "trace": {"wait": 1, "warmup": 1, "active": 2}}}
CPU = torch.device("cpu")


def _run(traced: bool = False, seconds: float = 0.5) -> dict:
    result, _checks = run.run_cell(CELL, BIG, seconds, traced, CPU,
                                   time.perf_counter(), spec_override=TINY)
    return result


def test_sound_run_is_correct():
    r = _run()
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 4 and set(r["metrics"]) == {"steps_per_s",
                                                         "setup_s"}


def test_traced_run_reads_every_metric():
    """Every geom.* metric but K7's roofline, whose kernel runs only on
    the card (the CPU runs its plain version)."""
    r = _run(traced=True, seconds=1.0)
    names = {m["name"] for m in common.benchmark()["per_layer"]
             if CELL in m["workloads"]} - {"geom.rgb_bwd_roofline"}
    assert set(r["metrics"]) == names, set(r["metrics"]) ^ names
    assert r["metrics"]["geom.step_mfu"]["value"] > 0
    assert r["metrics"]["geom.densify_ms"]["value"] == 0.0  # no device op


def test_control_fails():
    limits = common.cell(CELL)[3]["limits"]
    r = control.readings(CELL, 77, 0.5, CPU, TINY)
    assert any(r["control"][k] > limits[k] for k in limits), r
    for fault in control.FAULTS["steps"]:
        assert any(r[fault][k] > limits[k] for k in limits), (fault, r)


def test_unchanged_state_fails(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, *a, **k: None)
    assert not _run()["correct"]


def test_half_batch_fails(monkeypatch):
    from langsplatv2_tpu_torch.utils import losses

    def top_half(fn):
        def half(pred, gt, *a, **k):
            h = pred.shape[-2] // 2
            return fn(pred[..., :h, :], gt[..., :h, :], *a, **k)
        return half

    monkeypatch.setattr(losses, "l1_loss", top_half(losses.l1_loss))
    monkeypatch.setattr(losses, "ssim", top_half(losses.ssim))
    assert not _run()["correct"]


@pytest.mark.parametrize("threshold", [False, True])
def test_round_keeps_or_doubles(threshold):
    """The reference's round on a hand-made set: a hot small Gaussian is
    cloned, a hot large one split in two (scales over 1.6, positions
    inside its ellipsoid), a transparent one pruned, and with the size
    threshold on a Gaussian wider than 0.1 extent is pruned too."""
    n = 5
    fields = dict(
        xyz=torch.zeros((n, 3)), features_dc=torch.ones((n, 1, 3)),
        features_rest=torch.zeros((n, 15, 3)),
        scaling=torch.log(torch.tensor([[0.001] * 3, [0.05] * 3,
                                        [0.001] * 3, [0.001] * 3,
                                        [0.2] * 3])),
        rotation=torch.tensor([[1.0, 0, 0, 0]] * n),
        opacity=torch.tensor([[2.0], [2.0], [2.0], [-8.0], [2.0]]))
    accum = torch.tensor([1e-3, 1e-3, 0.0, 0.0, 0.0])
    denom = torch.tensor([1.0, 1.0, 0.0, 1.0, 1.0])
    eps = torch.full((2, n, 3), 0.5)
    cfg = {"densify_grad_threshold": 2e-4, "percent_dense": 0.01}
    out = gs.ref.densify_round(fields, accum, denom, eps, 1.0, cfg,
                               threshold)
    scales = torch.exp(out["scaling"]).max(1).values
    want = sorted([0.001, 0.001, 0.001, 0.05 / 1.6, 0.05 / 1.6]
                  + ([] if threshold else [0.2]))
    assert sorted(scales.tolist()) == pytest.approx(want, rel=1e-5)
    kids = out["xyz"][torch.isclose(scales, torch.tensor(0.05 / 1.6))]
    assert torch.allclose(kids, torch.full_like(kids, 0.025))


def test_restore_gives_the_snapshot_back():
    """Set-up's state and the state after a restore are the same tensors'
    values, whatever the replay did in between."""
    from types import SimpleNamespace

    _w, cfg, mix, spec = common.cell(CELL)
    ctx = SimpleNamespace(cfg={**cfg, **TINY["config"]},
                          mix={**mix, **TINY["traffic"]},
                          spec={**spec, **TINY["cell"]}, seed=BIG,
                          device=CPU)
    st = gs.setup(ctx)
    start = {k: getattr(st.model, k).detach().clone() for k in gs.FIELDS}
    gs.run(st, steps=9)
    assert st.k == 1 and len(st.restore_s) == 1
    gs.restore(st)
    for k in gs.FIELDS:
        torch.testing.assert_close(getattr(st.model, k).detach(), start[k],
                                   atol=0, rtol=0)
    state = st.optimizer.state[st.model.xyz]
    assert int(state["step"]) == cfg["replay"]["first"] - 1
