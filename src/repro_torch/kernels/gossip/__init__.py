"""Delay-bucketed gossip drain: CUDA kernel, wrapper, build."""
