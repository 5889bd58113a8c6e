"""Training (port of langsplatv2_tpu/train/ and scripts/train.py): both
phases, the flag groups and the command line."""
