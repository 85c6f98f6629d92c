"""Compute ops: plain PyTorch versions and the CUDA kernels that replace the
JAX package's Pallas kernels on the card."""
