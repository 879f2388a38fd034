"""Rendering: camera math and the software rasterizer (the raymarcher comes later)."""
