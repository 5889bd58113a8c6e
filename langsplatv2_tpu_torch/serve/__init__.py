"""Port of langsplatv2_tpu/serve/: the render server (backend.py) and its
command line (backend_renderer.py), its clients (frontend.py: the
pipelined client and the viser web GUI), and the SIBR viewer's bridge
(network_gui.py)."""
