"""PyTorch/CUDA port of the JAX package ``repro``: the serving replica on one NVIDIA H100."""
