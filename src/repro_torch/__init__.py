"""PyTorch/CUDA port of LiveVectorLake for NVIDIA Hopper (H100).

Same subpackage layout as the JAX package ``repro`` and the same on-disk
store format; the two TPU kernels on the serving path are hand-written
CUDA (``csrc/``) built with ``nvcc`` at first use. Imports ``torch``,
never ``jax``, and nothing of ``repro``.
"""
