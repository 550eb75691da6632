"""sdxl_tpu_torch — the PyTorch/CUDA port of sdxl_tpu for one NVIDIA H100.

A second package beside ``sdxl_tpu`` (the JAX reference, which stays as it
is). Module names mirror ``sdxl_tpu/`` so each module's counterpart is easy
to find. The package imports ``torch`` and never ``jax``, and nothing of
``sdxl_tpu`` either, not even its JAX-free modules: it keeps its own
copies of the configs and the BPE tokenizer.

Hand-written Hopper kernels live in ``csrc/`` and are built with nvcc at
first use (see ops/flash_attention.py).
"""

__version__ = "0.1.0"
