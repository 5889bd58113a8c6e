"""Cameras and scene ground truth (port of langsplatv2_tpu/scene/)."""
