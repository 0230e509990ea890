"""Hand-written CUDA kernels of the port (sources in ``../csrc``), each
beside its plain PyTorch version, which the CPU path runs."""
