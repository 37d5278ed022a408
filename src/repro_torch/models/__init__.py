"""Models: layer primitives, attention, the unified decoder, registry."""
