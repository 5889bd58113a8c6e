"""K9, the cell-chain probe: the port's plain version against JAX's kernel.

`kernel` is a closure inside scripts/profile_vpu_bf16.py::main, so its
FunctionDef is taken from the script with `ast` (the script is not
edited), run with `jnp` and REPS = 64 bound, through
pl.pallas_call(..., interpret=True) vmapped over 2 blocks as the script's
:53-56 and its batched form do. The port runs
langsplatv2_tpu_torch/ops/probe.py::cell_chain on the CPU (its plain
version); tests/test_torch_port_gpu.py holds the CUDA kernel against it.

XLA:CPU keeps bf16 intermediates in f32 by default
(--xla_allow_excess_precision), so in interpret mode JAX's bf16 chain is an
f32 chain on bf16 inputs (its acc reaches 63.996, which bf16 cannot hold),
not the bf16 arithmetic the kernel asks for. The bf16 case therefore runs
JAX in a subprocess with that flag off, where every op rounds to bf16.
"""
import ast
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from langsplatv2_tpu_torch.ops import probe

SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / \
    "profile_vpu_bf16.py"


def _jax_kernel():
    tree = ast.parse(SCRIPT.read_text())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    fn = next(n for n in ast.walk(main)
              if isinstance(n, ast.FunctionDef) and n.name == "kernel")
    scope = {"jnp": jnp, "REPS": probe.REPS}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), str(SCRIPT),
                 "exec"), scope)
    return scope["kernel"]


def _blocks():
    x = np.random.default_rng(1).uniform(-1, 1, (2, 256, 256))
    return x.astype(np.float32)


def _jax_chain(dtype_name: str) -> np.ndarray:
    """JAX's kernel in interpret mode, vmapped over the 2 blocks."""
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype_name]
    f = pl.pallas_call(
        functools.partial(_jax_kernel(), dtype=jdt),
        out_shape=jax.ShapeDtypeStruct((256, 256), jnp.float32),
        interpret=True)
    return np.asarray(jax.jit(jax.vmap(f))(jnp.asarray(_blocks())))


def _jax_chain_without_excess_precision(dtype_name: str, tmp_path):
    out = tmp_path / "ref.npy"
    code = ("import os, sys, numpy as np; "
            "sys.path[:0] = [sys.argv[1], os.path.dirname(sys.argv[1])]; "
            "import test_torch_port_probe as t; "
            f"np.save(sys.argv[2], t._jax_chain({dtype_name!r}))")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false")
    subprocess.run([sys.executable, "-c", code, str(Path(__file__).parent),
                    str(out)], env=env, check=True, capture_output=True,
                   timeout=300)
    return np.load(out)


def _bf16_ulp(v: float) -> float:
    return 2.0 ** (np.floor(np.log2(v)) - 7)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cell_chain_matches_jax_kernel(dtype, tmp_path):
    """f32: within 1e-5 of the largest output. bf16: within 2 bf16 ulps of
    the largest (both round each op's f32 result to bf16; exp's f32 ulp
    may still move an element by a bf16 ulp), and at most 1% of the
    elements differ at all (0 on these blocks)."""
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    ref = (_jax_chain(dtype) if dtype == "f32"
           else _jax_chain_without_excess_precision(dtype, tmp_path))
    out = probe.cell_chain(_blocks(), tdt, device="cpu").numpy()
    assert out.shape == ref.shape == (2, 256, 256) and out.dtype == np.float32
    big = float(np.abs(ref).max())
    assert 30.0 < big < 64.0
    err = float(np.abs(out - ref).max())
    differ = int((out != ref).sum())
    if dtype == "f32":
        assert err <= 1e-5 * big, err
    else:
        assert err <= 2 * _bf16_ulp(big), (err, differ)
        assert differ <= ref.size // 100, f"{differ} elements differ"


def test_bf16_compare_limits_are_exact():
    """The bf16 kernel compares packed bf16 values against +-BF16_LIM; over
    all 65,536 bf16 bit patterns (NaNs, infinities, signed zeros
    included), f32(v) <= LIM equals v <= BF16_LIM and f32(v) >= -LIM equals
    v >= -BF16_LIM, BF16_LIM is a bf16 value, and the next bf16 value above
    it is past LIM."""
    v = torch.arange(1 << 16, dtype=torch.int32).to(torch.int16).view(
        torch.bfloat16)
    lim = torch.tensor(probe.BF16_LIM, dtype=torch.bfloat16)
    assert float(lim) == probe.BF16_LIM
    assert bool(((v.float() <= probe.LIM) == (v <= lim)).all())
    assert bool(((v.float() >= -probe.LIM) == (v >= -lim)).all())
    above = (torch.tensor(probe.BF16_LIM, dtype=torch.bfloat16).view(
        torch.int16) + 1).view(torch.bfloat16)
    assert float(above) > probe.LIM > probe.BF16_LIM
