"""Model configs: `ModelConfig` and one module per ported architecture."""
