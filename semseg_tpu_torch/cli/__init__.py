"""Command-line entry points of the port (``python -m semseg_tpu_torch.cli.test``)."""
