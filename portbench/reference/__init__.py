"""The plain reference: PyTorch only, TF32 off, in blocks that fit.

It imports nothing of the program (`langsplatv2_tpu_torch`) and nothing
of the JAX package, and takes nothing the program made: it works out the
projection, the entries, the blend, the prompt products, the loss, the
gradients and Adam again from the benchmark's own inputs.
"""
