"""Hand-written Hopper kernels and their plain torch versions."""
