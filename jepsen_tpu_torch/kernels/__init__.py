"""Hand-written CUDA kernels of the search, their build and wrappers."""
