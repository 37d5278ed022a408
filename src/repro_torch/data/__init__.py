"""Synthetic federated data and the paper-scale MLP."""
