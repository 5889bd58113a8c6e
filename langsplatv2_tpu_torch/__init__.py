"""PyTorch/CUDA port of langsplatv2_tpu for one NVIDIA H100.

The JAX package `langsplatv2_tpu/` is the reference; each module here names
its counterpart there by file. This package imports torch and numpy only —
never jax, and nothing of `langsplatv2_tpu` (whose own `__init__` imports
jax).

Slices in place: the serving path of the merged 3-level quick model —
preprocess -> entry expansion (CUDA kernel K1) -> key sort -> tile blend
(CUDA kernel K2) -> Gram relevancy query (CUDA kernel K3) -> relevancy
tail; and the exact feature-phase training step (`train/trainer.py`) —
the same K1/K2 forward, the fused Gram-space loss (K6a forward, K6b
backward), the W-replay feature backward (K4) and Adam; the geometry
(RGB) phase (K7); capped feature training (K5) and fast16 serving; and the
render server (`serve/`) with temporal binning reuse (`ops/temporal.py`)
and the fused Gram-query frame (K2's query mode, K2q). Kernels are built from `csrc/` with nvcc at first use
(`ops/kernels.py`); on CPU tensors every kernel wrapper runs its plain
PyTorch version instead.

Entry points take `device=`; they run on "cuda" unless the caller passes
`device="cpu"`, and raise when CUDA is asked for but absent.
"""
