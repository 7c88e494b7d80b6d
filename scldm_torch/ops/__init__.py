"""Plain PyTorch ops and the kernels' wrappers."""
