"""Tensor ops: plain functions on torch tensors, plus the flash-attention kernel wrapper."""
