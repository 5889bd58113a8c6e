"""The check that decides `correct`, at sizes a CPU test can hold: sound
runs pass, and the control (the reference in TF32 in the program's place)
and each fault a cell can have, planted under the timed path, come out
not correct. The card's look is skipped: the runs call run_cell on the
CPU, where the program runs its kernels' plain versions."""
import time

import pytest
import torch

from portbench import common, control, run

BIG = 2 ** 31 + 4099
SERVE = ("lerf_quick_1m.orbit_1080p", "lerf_quick_1m.eval_986")
TRAIN = "lerf_feature_1m.gram_544x960"
CELL = {"probe_entries": 1 << 16, "sample_frames": 2, "extra_warm_steps": 1,
        "trace": {"wait": 1, "warmup": 1, "active": 2}}
TINY = {
    SERVE[0]: {"config": {"n_gaussians": 3000},
               "traffic": {"width": 64, "height": 48, "views": 3},
               "cell": CELL},
    SERVE[1]: {"config": {"n_gaussians": 3000},
               "traffic": {"width": 64, "height": 48, "views": 3,
                           "positives": [2, 4]},
               "cell": CELL},
    TRAIN: {"config": {"n_gaussians": 3000},
            "traffic": {"width": 64, "height": 48, "views": 3,
                        "segments": [5, 9]},
            "cell": CELL},
}
CPU = torch.device("cpu")


def _run(workload: str, seed: int = BIG, traced: bool = False,
         seconds: float = 0.5) -> dict:
    result, _checks = run.run_cell(workload, seed, seconds, traced, CPU,
                                   time.perf_counter(),
                                   spec_override=TINY[workload])
    return result


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the benchmark measures only there)")


@pytest.mark.parametrize("workload", SERVE + (TRAIN,))
def test_sound_run_is_correct(workload):
    r = _run(workload)
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks" and r["attempted"] >= 1


@pytest.mark.parametrize("workload", SERVE + (TRAIN,))
def test_control_fails(workload):
    limits = common.cell(workload)[3]["limits"]
    r = control.readings(workload, 77, 0.5, CPU, TINY[workload])
    assert any(r["control"][k] > limits[k] for k in limits), r


@pytest.mark.parametrize("workload", SERVE)
def test_altered_answer_fails(workload, monkeypatch):
    from langsplatv2_tpu_torch.eval.openclip import OpenCLIPNetwork

    original = OpenCLIPNetwork.relevancy_from_tiles

    def altered(self, *args, **kwargs):
        relev = original(self, *args, **kwargs)
        relev[..., :16, :16] = 1.0 - relev[..., :16, :16]
        return relev

    monkeypatch.setattr(OpenCLIPNetwork, "relevancy_from_tiles", altered)
    assert not _run(workload)["correct"]


@pytest.mark.parametrize("workload", SERVE)
def test_altered_map_fails(workload, monkeypatch):
    from langsplatv2_tpu_torch.ops import rasterize

    original = rasterize._assemble

    def altered(settings, rgb_t, feat_t, *args):
        feat_t = feat_t.clone()
        feat_t[0] = feat_t[0].flip(0)
        return original(settings, rgb_t, feat_t, *args)

    monkeypatch.setattr(rasterize, "_assemble", altered)
    assert not _run(workload)["correct"]


def test_unchanged_state_fails(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, *a, **k: None)
    assert not _run(TRAIN)["correct"]


def test_half_batch_fails(monkeypatch):
    from langsplatv2_tpu_torch.train import trainer

    original = trainer.gram_loss_fused

    def half(codebooks, wmap_tiles, gt_table, seg_map, layer_idx, *a, **k):
        h = seg_map.shape[0] // 2
        seg = seg_map.clone()
        seg[h:] = -1
        # The loss over the top half's pixels, the mean over those alone.
        return 2.0 * original(codebooks, wmap_tiles, gt_table, seg,
                              layer_idx, *a, **k) - 1.0

    monkeypatch.setattr(trainer, "gram_loss_fused", half)
    assert not _run(TRAIN)["correct"]


def test_traced_run_reads_its_metrics():
    r = _run(TRAIN, traced=True, seconds=4.0)
    assert set(r["metrics"]) >= {"train.dispatch_ms"}
    assert "breakdown" in r and "window_s" in r["device"]


def test_main_refuses_without_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    rc = run.main(["--workload", SERVE[0], "--seed", str(BIG),
                   "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""


@pytest.mark.parametrize("workload", SERVE + (TRAIN,))
def test_short_run_on_card(card, workload, capsys):
    assert run.main(["--workload", workload, "--seed", str(BIG),
                     "--seconds", "2", "--trace", "0"]) == 0
    assert '"correct": true' in capsys.readouterr().out
