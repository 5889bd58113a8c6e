"""Stage A on the device: images -> SAM masks -> CLIP features
(port of langsplatv2_tpu/preprocess). `python -m
langsplatv2_tpu_torch.preprocess.cli` writes a scene's
language_features; `python -m langsplatv2_tpu_torch.preprocess.convert`
runs COLMAP on its input images."""
