"""Port of langsplatv2_tpu/serve/: the render server (backend.py) and the
pipelined client (frontend.py)."""
