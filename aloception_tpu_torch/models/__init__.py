"""Model zoo (PyTorch): Deformable-DETR so far."""
