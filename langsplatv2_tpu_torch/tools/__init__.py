"""User render tools over a trained scene (ports of scripts/demo_prompt.py,
scripts/debug_renderer.py and scripts/simple_viser.py), each a
`python -m langsplatv2_tpu_torch.tools.<name>` entry point."""
