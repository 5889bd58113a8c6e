"""Training (port of langsplatv2_tpu/train/): the feature phase, exact
route."""
