"""sdxl_tpu_torch — the PyTorch/CUDA port of sdxl_tpu for one NVIDIA H100.

A second package beside ``sdxl_tpu`` (the JAX reference, which stays as it
is). Module names mirror ``sdxl_tpu/`` so each module's counterpart is easy
to find. The package imports ``torch`` and never ``jax``; from ``sdxl_tpu`` it uses only the
JAX-free ``sdxl_tpu.configs`` and ``sdxl_tpu.tokenizer``.

Hand-written Hopper kernels live in ``csrc/`` and are built with nvcc at
first use (see ops/flash_attention.py).
"""

__version__ = "0.1.0"
