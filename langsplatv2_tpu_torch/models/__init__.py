"""Port of langsplatv2_tpu/models/ (the Gaussian model, checkpoint reader, renderer)."""
