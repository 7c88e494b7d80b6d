"""Generation-time samplers."""
