"""Qualitative result export: point clouds and box wireframes as ``.obj``,
3D boxes drawn on images."""
