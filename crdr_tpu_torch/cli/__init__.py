"""Command-line entry points of the port (``python -m crdr_tpu_torch.cli.<name>``)."""
