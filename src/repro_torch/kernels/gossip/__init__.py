"""Gossip kernels (delay-bucketed drain, row-stochastic mix, bucketed
enqueue): CUDA sources, wrappers, plain versions."""
