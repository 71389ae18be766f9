"""Device operations: plain PyTorch versions and their CUDA kernels."""
