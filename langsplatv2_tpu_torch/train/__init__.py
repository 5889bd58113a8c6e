"""Training (port of langsplatv2_tpu/train/, scripts/train.py and
scripts/run_all_levels.sh): both phases, the flag groups and the command
lines."""
