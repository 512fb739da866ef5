"""Geometry, table builds, simplex interpolation and the packed cascade."""
