"""Hand-written CUDA kernels (sources in this directory) and their build."""
