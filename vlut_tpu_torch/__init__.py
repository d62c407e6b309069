"""vlut_tpu_torch: the PyTorch/CUDA port of vlut_tpu for NVIDIA Hopper.

Packed-ternary (i2/i1) llama/bitnet inference with hand-written CUDA
kernels (``csrc/``); the JAX package ``vlut_tpu`` is the reference it is
held against.  Importing the package loads nothing heavy and builds no
kernel: kernels compile at first use on a GPU.
"""
