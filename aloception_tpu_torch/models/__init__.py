"""Model zoo (PyTorch): DETR and Deformable-DETR, inference and training;
RAFT optical flow, inference."""
