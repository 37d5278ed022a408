"""Mamba2 SSD intra-chunk kernel: CUDA source, wrapper, plain version."""
