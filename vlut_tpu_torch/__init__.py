"""vlut_tpu_torch: the PyTorch/CUDA port of vlut_tpu for NVIDIA Hopper.

Packed-ternary (i2/i1) llama/bitnet inference with hand-written CUDA
kernels (``csrc/``); the JAX package ``vlut_tpu`` is the reference it is
held against.  Beside serving (``runtime/``, ``serving/``, ``cli.py``) it
carries the evaluation tools: the kernel microbenchmark with llama.cpp's
TQ2_0/TQ1_0 baseline lanes (``bench/kernels.py``, ``ops/tq.py``), the
end-to-end benches (``bench/e2e.py``), perplexity and accuracy tasks
(``eval/``; ``forward(..., impl="dequant")`` is the float reference) and
exact i2 <-> i1 requantization (``convert/quantize.py``).  Importing the
package loads nothing heavy and builds no kernel: kernels compile at first
use on a GPU.
"""
