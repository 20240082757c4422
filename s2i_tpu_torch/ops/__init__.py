"""The port's CUDA kernels (csrc/), their builder and their Python wrappers."""
