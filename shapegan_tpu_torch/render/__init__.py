"""Rendering: camera math, the software rasterizer and the sphere-traced
raymarcher."""

from shapegan_tpu_torch.render.raymarching import render_image, render_image_for_index

__all__ = ["render_image", "render_image_for_index"]
