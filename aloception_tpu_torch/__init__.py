"""aloception_tpu_torch: the PyTorch/CUDA port of aloception_tpu for NVIDIA
Hopper. It imports torch and numpy, never jax, flax or aloception_tpu."""
