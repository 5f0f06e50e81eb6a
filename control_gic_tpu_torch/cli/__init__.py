"""Command-line entry points (python -m control_gic_tpu_torch.cli.<name>)."""
