"""Command-line tools of the port (``python -m semseg_tpu_torch.tools.<name>``)."""
