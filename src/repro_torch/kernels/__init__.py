"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version. A wrapper runs the plain version on a CPU tensor and launches the
kernel on a CUDA tensor (or raises)."""
