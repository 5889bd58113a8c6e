"""Port of langsplatv2_tpu/utils/ (camera math, transforms, SH, sparse codes)."""
