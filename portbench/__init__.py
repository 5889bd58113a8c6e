"""The benchmark of langsplatv2_tpu_torch (see README.md)."""
