"""Model building blocks (the slice needs only what make_mlp uses)."""
