"""Command-line entry points (``python -m simplellminference_tpu_torch.cli.
generate``)."""
