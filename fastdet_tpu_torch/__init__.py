"""fastdet_tpu_torch: the fastdet detection server on PyTorch and CUDA.

A port of the JAX/TPU package ``fastdet_tpu`` (kept beside it as the
reference) to an NVIDIA H100. It imports neither JAX nor the JAX
package. Entry points run on the CUDA card unless the caller passes
``device="cpu"``; the ingest kernels are hand-written CUDA C++
(``csrc/``), built with nvcc at first use and bound with ctypes.
"""
