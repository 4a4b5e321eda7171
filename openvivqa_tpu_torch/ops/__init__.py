"""Hand-written Hopper kernels (``csrc/``) and their plain PyTorch versions."""
