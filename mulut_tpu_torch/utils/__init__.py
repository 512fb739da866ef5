"""LUT artifact IO."""
