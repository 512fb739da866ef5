"""LUT artifact IO, image IO, metrics and logging."""
