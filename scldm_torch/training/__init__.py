"""Tasks (generation so far)."""
