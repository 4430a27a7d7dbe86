"""The repository's examples on the port (``examples/``), run as
``python -m m3p2i_aip_tpu_torch.examples.<name>``."""
