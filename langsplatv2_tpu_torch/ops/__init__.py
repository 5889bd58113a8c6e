"""Port of langsplatv2_tpu/ops/ (preprocess, binning, blend, query, rasterize)
with the CUDA kernel wrappers and their build (kernels.py)."""
