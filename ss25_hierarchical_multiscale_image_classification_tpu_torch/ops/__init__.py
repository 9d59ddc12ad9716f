"""Hand-written CUDA kernels (``csrc/``), their build, and their wrappers
with plain PyTorch versions beside them."""
