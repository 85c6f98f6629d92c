"""Model zoo (PyTorch): DETR and Deformable-DETR inference so far."""
