"""Gossip kernels (delay-bucketed drain, row-stochastic mix): CUDA
sources, wrappers, build."""
