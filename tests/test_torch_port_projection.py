"""The preprocess's dispatch rule and its interfaces, on the CPU.

`projection.preprocess` launches csrc/preprocess.cu only for CUDA tensors
that need no gradient (tests/test_torch_port_gpu.py holds the kernel to
the plain path on the card); here every call takes the plain path. The
SH coefficients may come as one [N, K, 3] tensor or as the model's
(features_dc, features_rest) pair. This file imports no JAX.
"""
import ctypes
import re

import numpy as np
import pytest
import torch

from langsplatv2_tpu_torch import tracing
from langsplatv2_tpu_torch.device import to_f32
from langsplatv2_tpu_torch.ops import kernels, projection

from torch_port_fixtures import camera, scene


def _inputs(n: int = 400, deg: int = 3, seed: int = 2):
    sc = scene(n, seed=seed)
    rng = np.random.default_rng(seed)
    shs = (rng.normal(size=(n, (deg + 1) ** 2, 3)) * 0.3).astype(np.float32)
    view, pm, tfx, tfy = camera(96, 128)
    T = torch.from_numpy
    return dict(means=T(sc["means"]), scales=T(sc["scales"]),
                rotations=T(sc["rotations"]), shs=T(shs),
                ops=T(sc["opacities"][:, 0]), view=view, pm=pm,
                campos=np.float32([0.1, -0.2, -0.3]), tfx=tfx, tfy=tfy)


def _call(x, shs, fn=projection.preprocess, deg=3, **kw):
    return fn(x["means"], x["scales"], x["rotations"], shs, None, x["view"],
              x["pm"], x["campos"], x["tfx"], x["tfy"], 128, 96, deg, 1.0,
              opacities=x["ops"], **kw)


def _equal(a, b):
    for name in a._fields:
        u, v = getattr(a, name), getattr(b, name)
        assert (u is None) == (v is None), name
        if u is not None:
            assert torch.equal(u, v), name


def test_cpu_takes_the_plain_path(monkeypatch):
    """CPU tensors go to preprocess_plain, never to the kernel, and count
    neither a launch nor a plain call (the counters count CUDA calls)."""
    def refuse(*_a, **_k):
        raise AssertionError("the kernel path ran on CPU tensors")

    monkeypatch.setattr(projection, "preprocess_kernel", refuse)
    x = _inputs()
    before = tracing.counters()
    out = _call(x, x["shs"])
    after = tracing.counters()
    _equal(out, _call(x, x["shs"], projection.preprocess_plain))
    for k in ("preprocess.launches", "preprocess.plain_calls"):
        assert after.get(k, 0) == before.get(k, 0), k
    assert int((out.radius > 0).sum()) > 100


@pytest.mark.parametrize("deg", [0, 1, 3])
def test_sh_pair_matches_the_concatenated_tensor(deg):
    """The (dc, rest) pair gives the [N, K, 3] tensor's outputs exactly,
    and under autograd the same gradients to both halves."""
    x = _inputs(deg=deg)
    shs = x["shs"]
    _equal(_call(x, (shs[:, :1], shs[:, 1:]), deg=deg), _call(x, shs,
                                                               deg=deg))
    dc = shs[:, :1].clone().requires_grad_(True)
    rest = shs[:, 1:].clone().requires_grad_(True)
    _call(x, (dc, rest), deg=deg).rgb.sum().backward()
    whole = shs.clone().requires_grad_(True)
    _call(x, whole, deg=deg).rgb.sum().backward()
    assert torch.equal(dc.grad, whole.grad[:, :1])
    assert torch.equal(rest.grad, whole.grad[:, 1:])


@pytest.mark.parametrize("grad_mode,leaf,expect", [
    (True, None, False), (True, "scales", True), (True, "dc", True),
    (True, "campos", True), (False, "scales", False)])
def test_needs_grad_rule(grad_mode, leaf, expect):
    """The kernel's half of the rule: no input requires_grad, or grad mode
    off; the SH pair's halves and the camera count as inputs."""
    x = _inputs(n=8)
    dc, rest = x["shs"][:, :1].clone(), x["shs"][:, 1:].clone()
    campos = torch.zeros(3)
    named = {"scales": x["scales"].clone(), "dc": dc, "campos": campos}
    if leaf is not None:
        named[leaf].requires_grad_(True)
    with torch.set_grad_enabled(grad_mode):
        got = projection._needs_grad(x["means"], named["scales"],
                                     x["rotations"], (named["dc"], rest),
                                     None, x["view"], named["campos"])
    assert got is expect


def test_kernel_wrapper_refuses_what_the_kernel_does_not_take():
    """SH degree outside 0..4, too few coefficients for the degree, and a
    camera of the wrong size raise before any launch."""
    x = _inputs(n=16, deg=2)
    fn = projection.preprocess_kernel
    with pytest.raises(ValueError, match="outside 0..4"):
        _call(x, x["shs"], fn, deg=5)
    with pytest.raises(ValueError, match="SH coefficients for degree 3"):
        _call(x, x["shs"], fn, deg=3)
    bad = dict(x, view=np.eye(3, dtype=np.float32))
    with pytest.raises(ValueError, match="viewmatrix: 9 values"):
        _call(bad, x["shs"], fn, deg=2)


def test_host_params_follow_the_kernel_struct():
    """The wrapper's scalars are csrc/preprocess.cu's `Params` fields in
    order after the camera's 35 floats."""
    src = (kernels.CSRC / "preprocess.cu").read_text()
    body = re.search(r"struct Params \{(.*?)\};", src, re.S).group(1)
    fields = []
    for line in body.splitlines():
        line = line.split("//")[0].strip()
        if line.startswith("float ") and "cam[" not in line:
            fields += [f.strip() for f in line[6:].rstrip(";").split(",")]
    assert tuple(fields) == projection._SCALARS
    assert f"kCamFloats = {projection._CAM_FLOATS};" in src


def test_entry_points_match_the_c_signatures():
    """Every entry point's ctypes argument types (ops/kernels.py) against
    its C signature in csrc: a pointer, int, float or long long each."""
    kinds = {"int": ctypes.c_int, "float": ctypes.c_float,
             "long long": ctypes.c_longlong}
    src = "".join(p.read_text() for p in sorted(kernels.CSRC.glob("*.cu")))
    found = {}
    for m in re.finditer(r'extern "C" int (lsv2_\w+)\(([^)]*)\)', src):
        types = []
        for arg in (a.strip() for a in m.group(2).split(",") if a.strip()):
            if "*" in arg:
                types.append(ctypes.c_void_p)
            else:
                types.append(next(t for k, t in kinds.items()
                                  if arg.startswith(k + " ")))
        found[m.group(1)] = types
    assert found == kernels.ENTRY_POINTS


def test_to_f32_on_the_cpu():
    """Host data to a CPU device is a plain float32 tensor; None stays."""
    assert to_f32(None, "cpu") is None
    t = to_f32(np.arange(3, dtype=np.float64), torch.device("cpu"))
    assert t.dtype == torch.float32 and t.device.type == "cpu"
    assert torch.equal(t, torch.tensor([0.0, 1.0, 2.0]))
    pair = projection.shs_f32((np.zeros((2, 1, 3)), np.ones((2, 0, 3))),
                              "cpu")
    assert isinstance(pair, tuple) and pair[1].shape == (2, 0, 3)
