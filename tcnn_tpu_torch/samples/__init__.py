"""Samples of the port: ``python -m tcnn_tpu_torch.samples.<name>``."""
