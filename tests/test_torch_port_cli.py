"""The port's training command line and what it stands on, against the JAX
package: the residual k-means codebook init (held to JAX's centres given
JAX's k-means++ centres and mini-batch indices: torch's generator is not
jax.random), `safe_state`, the flag groups and the persisted config, and
`python -m langsplatv2_tpu_torch.train.cli --device cpu` on a tiny COLMAP
scene: both phases, scripts/train.py's artifacts, a same-phase resume
that restores the Adam moments, and checkpoints JAX reads.
"""
import argparse
import io as pyio
import json
import os
import random
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from langsplatv2_tpu.models import io as jax_io
from langsplatv2_tpu.train import config as jax_config
from langsplatv2_tpu.train import trainer as jax_trainer
from langsplatv2_tpu.utils import sparse_codes as jax_codes
from langsplatv2_tpu.utils import system as jax_system
from langsplatv2_tpu_torch.models import io
from langsplatv2_tpu_torch.train import cli, config
from langsplatv2_tpu_torch.utils import sparse_codes, system

from torch_port_fixtures import write_colmap_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------- k-means

def _jax_draws(key, points, num_levels, num_clusters, iters, batch):
    """The k-means++ centres and batch indices JAX's
    residual_kmeans_codebooks draws at each level (its key splits)."""
    init, idx = [], []
    residuals = points
    for _ in range(num_levels):
        key, sub = jax.random.split(key)
        init_key, batch_key = jax.random.split(sub)
        centers = jax_codes._kmeans_pp_init(init_key, residuals,
                                            num_clusters)
        init.append(np.asarray(centers))
        idx.append(np.stack([np.asarray(jax.random.randint(
            k, (batch,), 0, points.shape[0]))
            for k in jax.random.split(batch_key, iters)]))
        final = jax_codes.minibatch_kmeans(sub, residuals, num_clusters,
                                           iters, batch)
        residuals = residuals - final[jax_codes._assign(residuals, final)]
    return init, idx


def test_residual_kmeans_matches_jax():
    """Two levels of 16 centres over clustered 512-d points, 8 mini-batches
    of 256: the centres at 1e-5, with JAX's draws handed to the port."""
    rng = np.random.default_rng(0)
    centres = rng.normal(size=(12, 512)) * 3
    pts = (centres[rng.integers(0, 12, 1500)]
           + rng.normal(size=(1500, 512))).astype(np.float32)
    key = jax.random.PRNGKey(4)
    ref = np.asarray(jax_codes.residual_kmeans_codebooks(
        key, jnp.asarray(pts), 2, 16, iters=8, batch_size=256))
    init, idx = _jax_draws(key, jnp.asarray(pts), 2, 16, 8, 256)
    books = sparse_codes.residual_kmeans_codebooks(
        torch.from_numpy(pts), 2, 16, iters=8, batch_size=256,
        init_centers=init, batch_indices=idx)
    assert books.shape == (2, 16, 512)
    np.testing.assert_allclose(books.numpy(), ref, rtol=0, atol=1e-5)


def test_kmeans_draws_from_its_generator():
    """Without injected draws the port seeds from k-means++ (every centre
    a data point) and its batches from the generator: the same seed gives
    the same codebooks; points that all coincide do not stop it."""
    rng = np.random.default_rng(1)
    pts = torch.from_numpy(rng.normal(size=(300, 8)).astype(np.float32))
    init = sparse_codes.kmeans_pp_init(pts, 5, torch.Generator().manual_seed(2))
    assert all(bool((pts == c).all(1).any()) for c in init)
    assert torch.unique(init, dim=0).shape[0] == 5

    def books(seed):
        return sparse_codes.residual_kmeans_codebooks(
            pts, 2, 5, iters=4, batch_size=64,
            generator=torch.Generator().manual_seed(seed))

    torch.testing.assert_close(books(3), books(3), atol=0, rtol=0)
    assert not torch.equal(books(3), books(4))
    same = torch.ones((40, 8))
    out = sparse_codes.residual_kmeans_codebooks(
        same, 1, 4, iters=2, batch_size=16,
        generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(out[0], torch.ones((4, 8)))
    with pytest.raises(ValueError, match="generator"):
        sparse_codes.minibatch_kmeans(pts, 5, 2, 16)


# ---------------------------------------------------------- safe_state

def test_safe_state_matches_jax(monkeypatch):
    """The timestamped stream (a stamp before the newline of each write
    that ends one, nothing when silent), the seeded host generators, and
    the stream it returns."""
    outputs = {}
    for name, fn in (("port", system.safe_state),
                     ("jax", jax_system.safe_state)):
        for silent in (False, True):
            buf = pyio.StringIO()
            monkeypatch.setattr(sys, "stdout", buf)
            previous = fn(silent, seed=5)
            print("a line\nand another")
            draws = (random.random(), float(np.random.rand()))
            if name == "port":
                assert previous is buf
                assert torch.equal(torch.rand(3), torch.rand(
                    3, generator=torch.Generator().manual_seed(5)))
            monkeypatch.setattr(sys, "stdout", buf)
            outputs[name, silent] = (re.sub(r"\[\d\d/\d\d \d\d:\d\d:\d\d\]",
                                            "[stamp]", buf.getvalue()), draws)
    assert outputs["port", False] == outputs["jax", False]
    assert outputs["port", False][0] == \
        "a line\nand another [stamp]\n"
    assert outputs["port", True] == outputs["jax", True]
    assert outputs["port", True][0] == ""


# ----------------------------------------------------------- the flags

class _Parsed(Exception):
    pass


def _jax_train_parser(monkeypatch):
    """scripts/train.py's parser, caught at its parse_args."""
    def capture(self, *a, **k):
        raise _Parsed(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import train as jax_train_script
        with pytest.raises(_Parsed) as e:
            jax_train_script.main()
    finally:
        sys.path.remove(os.path.join(REPO, "scripts"))
    return e.value.args[0]


def _flags(parser):
    return {tuple(a.option_strings): (a.dest, a.default, a.type, a.nargs,
                                      type(a).__name__)
            for a in parser._actions if a.option_strings}


def test_cli_flags_match_scripts_train(monkeypatch):
    """The same flags, shorthands, defaults and types as scripts/train.py,
    plus --device; --data_device defaults to "cuda" (JAX's says "tpu",
    and no path reads it)."""
    ref = _flags(_jax_train_parser(monkeypatch))
    mine = _flags(cli.build_parser()[0])
    assert mine.pop(("--device",))[1] == "cuda"
    assert mine.pop(("--data_device",))[1] == "cuda"
    assert ref.pop(("--data_device",))[1] == "tpu"
    assert mine == ref


def test_cfg_args_round_trip(tmp_path):
    """save_cfg_args writes what JAX's writes; load_combined_args reads
    JSON, the reference's Namespace repr, and the other package's files,
    with command-line values winning."""
    parser = argparse.ArgumentParser()
    config.ModelParams(parser, sentinel=True)
    config.PipelineParams(parser)
    args = argparse.Namespace(model_path=str(tmp_path / "m"), sh_degree=2,
                              eval=True, images="imgs", cos_loss=True)
    config.save_cfg_args(str(tmp_path / "m"), args)
    jax_config.save_cfg_args(str(tmp_path / "j"), args)
    for name in ("cfg_args", "cfg_args.json"):
        assert (tmp_path / "m" / name).read_text() == \
            (tmp_path / "j" / name).read_text().replace(
                str(tmp_path / "j"), str(tmp_path / "m"))
    for d in ("m", "j"):
        argv = ["-m", str(tmp_path / d), "--resolution", "2"]
        got = config.load_combined_args(parser, argv)
        ref = jax_config.load_combined_args(parser, argv)
        assert vars(got) == vars(ref)
        assert got.sh_degree == 2 and got.resolution == 2 and got.cos_loss
    os.remove(tmp_path / "m" / "cfg_args.json")
    got = config.load_combined_args(parser, ["-m", str(tmp_path / "m")])
    assert got.images == "imgs" and got.eval is True
    extracted = config.ModelParams(argparse.ArgumentParser()).extract(
        argparse.Namespace(source_path="s", language_features_name="lf",
                           sh_degree=3))
    assert extracted.lf_path == os.path.join(os.path.abspath("s"), "lf")


# ------------------------------------------------------------- the CLI

def _run(argv):
    """cli.main in process; returns (summary, captured stdout)."""
    out = pyio.StringIO()
    previous = sys.stdout
    sys.stdout = out
    try:
        summary = cli.main(argv)
    finally:
        restored = sys.stdout
        sys.stdout = previous
    assert restored is out, "main must put sys.stdout back"
    return summary, out.getvalue()


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    write_colmap_scene(root / "scene", np.random.default_rng(0))
    out = str(root / "out" / "m")
    base = ["-s", str(root / "scene"), "-m", out, "--device", "cpu",
            "--max_entries", "16384", "--test_iterations", "6"]
    rgb = subprocess.run(
        [sys.executable, "-m", "langsplatv2_tpu_torch.train.cli", *base,
         "--iterations", "6", "--checkpoint_iterations", "6",
         "--save_iterations", "6", "--accum_iter", "2"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert rgb.returncode == 0, rgb.stdout[-3000:] + rgb.stderr[-3000:]
    resumed, resumed_out = _run(
        base + ["--start_checkpoint", f"{out}_-1/chkpnt6.npz",
                "--iterations", "10", "--checkpoint_iterations", "10",
                "--save_iterations", "10", "--accum_iter", "2"])
    feature, feature_out = _run(
        base + ["--include_feature", "--start_checkpoint",
                f"{out}_-1/chkpnt10.npz", "--feature_level", "1",
                "--cos_loss", "--topk", "4", "--codebook_size", "16",
                "--iterations", "6", "--checkpoint_iterations", "4", "6",
                "--cam_batch", "3"])
    pixel, pixel_out = _run(
        base + ["--include_feature", "--start_checkpoint",
                f"{out}_1/chkpnt4.npz", "--feature_level", "1",
                "--cos_loss", "--l1_loss", "--normalize", "--topk", "4",
                "--codebook_size", "16", "--iterations", "8",
                "--checkpoint_iterations", "8", "--accum_iter", "2"])
    return dict(out=out, rgb=rgb, resumed=resumed, resumed_out=resumed_out,
                feature=feature, feature_out=feature_out, pixel=pixel,
                pixel_out=pixel_out)


def test_cli_writes_scripts_train_artifacts(trained):
    """`<out>_<level>/` with cfg_args and cfg_args.json, cameras.json,
    input.ply, point_cloud/iteration_N/point_cloud.ply, chkpntN.npz and
    metrics.jsonl, for the geometry (-1) and feature (1) phases."""
    out = trained["out"]
    for d, its in ((f"{out}_-1", (6, 10)), (f"{out}_1", (4, 6, 8))):
        names = {os.path.relpath(os.path.join(r, f), d)
                 for r, _, fs in os.walk(d) for f in fs}
        expected = {"cfg_args", "cfg_args.json", "cameras.json", "input.ply",
                    "metrics.jsonl"}
        expected |= {f"chkpnt{i}.npz" for i in its}
        assert expected <= names, (d, names)
        with open(os.path.join(d, "cfg_args.json")) as f:
            assert json.load(f)["device"] == "cpu"
    for it in (6, 10):
        assert os.path.exists(f"{out}_-1/point_cloud/iteration_{it}/"
                              "point_cloud.ply")
    rows = [json.loads(line) for line in open(f"{out}_-1/metrics.jsonl")]
    assert {"iter": 6, "phase": "rgb"}.items() <= rows[0].items()
    assert any(r.get("split") == "train" for r in rows)
    assert "Optimizing" in trained["rgb"].stdout
    assert trained["feature"]["kmeans_s"] is not None


def test_cli_resume_restores_adam_moments(trained):
    """A same-phase resume continues at the checkpoint's iteration with
    its Adam moments: no "fresh moments" warning, and the update count
    goes on from the checkpoint's. With accum_iter 2 the first run (6
    iterations) updates at 2 and 4 (never at its last), the resumed run
    (7 to 10) at 8: 2, then 3 (fresh moments would give 1)."""
    out = trained["out"]
    assert "resuming with fresh moments" not in trained["resumed_out"]
    assert trained["resumed"]["first_iter"] == 6
    with np.load(f"{out}_-1/chkpnt6.npz") as a, \
            np.load(f"{out}_-1/chkpnt10.npz") as b:
        assert int(a["opt/0"]) == 2 and int(b["opt/0"]) == 3
        assert np.abs(b["opt/1"]).max() > 0


def test_feature_phase_trains_and_jax_reads_its_checkpoint(trained):
    """The feature phase from the geometry checkpoint (k-means codebooks,
    camera batches of 3) and its pixel-space resume (l1 + normalize with
    accum_iter 2) train with finite losses; JAX's load_checkpoint_auto and
    load_checkpoint with its feature optimizer's template read the
    port's checkpoint, moments included."""
    out = trained["out"]
    assert trained["feature"]["first_iter"] == 0
    assert trained["pixel"]["first_iter"] == 4
    assert "resuming with fresh moments" not in trained["pixel_out"]
    for r in (trained["feature"], trained["pixel"]):
        assert np.isfinite(r["losses"]).all() and len(r["losses"]) >= 4
    path = f"{out}_1/chkpnt8.npz"
    jm, it = jax_io.load_checkpoint_auto(path)
    assert it == 8 and jm.language_logits is not None
    assert jm.codebooks.shape == (1, 16, 512)
    port_model, _ = io.load_checkpoint(path, device="cpu")
    np.testing.assert_array_equal(np.asarray(jm.codebooks),
                                  port_model.codebooks.numpy())
    opt = jax_trainer.make_feature_optimizer(
        argparse.Namespace(language_feature_lr=0.0025))
    template = opt.init(jax_trainer.feature_params(jm))
    _, state, _, extra = jax_io.load_checkpoint(path, jm, template)
    assert extra == {"phase": "feature"}
    assert int(state["language_logits"][0].count) > 0
    assert float(jnp.abs(state["codebooks"][0].mu).max()) > 0


def test_cli_later_flags_raise(tmp_path):
    for flag in (["--impl", "xla"], ["--gui"]):
        with pytest.raises(NotImplementedError, match="later slice"):
            cli.main(["-s", "x", "-m", str(tmp_path / "m"), "--device", "cpu",
                      *flag])
    assert not (tmp_path / "m_-1").exists()
