"""Hand-written CUDA kernels of the port, their plain versions and their build."""
