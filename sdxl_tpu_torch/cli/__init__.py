"""Command-line entry points (counterpart of sdxl_tpu/cli/)."""
