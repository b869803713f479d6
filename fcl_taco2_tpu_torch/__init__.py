"""FCL-taco2 in PyTorch with hand-written CUDA kernels for Hopper (H100).

The port of ``fcl_taco2_tpu`` (JAX/Pallas, the frozen reference).  Module
and function names follow the JAX package so each counterpart is easy to
find; public functions keep its layouts (channels-last ``(B, T, C)``,
segment positions ``(P, D)``, decoder output ``(P, D, odim)``).

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; on the CPU every kernel wrapper runs its plain PyTorch
version.
"""

__version__ = "0.1.0"
