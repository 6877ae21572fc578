"""Hand-written CUDA kernels of the serving path, each beside its plain
version."""
