"""Command-line entry points (python -m bist_tpu_torch.cli.<name>)."""
