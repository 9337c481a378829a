"""Command-line entry points of the port, run as
``python -m ant_quantization_tpu_torch.tools.<name>``."""
