"""Hand-written GPU kernels (sources in ``csrc/``) with their plain PyTorch
versions; a CPU tensor takes the plain version, a CUDA tensor the kernel."""
