"""Software rasterizer with shadow mapping (counterpart of
:mod:`shapegan_tpu.render.software`).

Host code, not a device kernel: the scene goes through a multithreaded C++
rasterizer (``render/csrc/rasterizer.cpp``, the JAX package's source copied,
built with the host C++ compiler at first use into the git-ignored
``render/csrc/build/`` and bound with ctypes). It renders
the reference viewer's two-pass pipeline — a light-space depth pre-pass
into a shadow map, then the shaded camera pass with a shadowed floor —
without any display or GL context.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

from shapegan_tpu_torch.host_build import build_shared_library

SHADOW_TEXTURE_SIZE = 1024
SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "rasterizer.cpp")


def build_rasterizer() -> str:
    """Compile the rasterizer if this source revision has no library yet
    (``host_build.build_shared_library``); returns the library's path.
    Raises when the compiler is missing or fails: there is no fallback."""
    return build_shared_library(SOURCE, "librasterizer", "the C++ rasterizer")


@functools.lru_cache(maxsize=None)
def _rasterizer() -> ctypes.CDLL:
    lib = ctypes.CDLL(build_rasterizer())
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.rasterize_scene.restype = None
    lib.rasterize_scene.argtypes = [
        f32p, f32p, ctypes.c_long,          # vertices, normals, n_vertices
        f32p, f32p, f32p,                   # camera_vp, light_vp, light_vp_inv
        ctypes.c_float, ctypes.c_int,       # ground_level, draw_floor
        f32p, f32p,                         # albedo, background
        ctypes.c_int, ctypes.c_int,         # size, shadow_size
        ctypes.POINTER(ctypes.c_ubyte),     # out_rgb
    ]
    return lib


def render_scene(
    vertices: np.ndarray,
    normals: np.ndarray,
    camera_vp: np.ndarray,
    light_vp: np.ndarray,
    *,
    size: int = 800,
    shadow_size: int = SHADOW_TEXTURE_SIZE,
    ground_level: float = -1.0,
    draw_floor: bool = True,
    albedo=(0.8, 0.1, 0.1),
    background=(1.0, 1.0, 1.0),
) -> np.ndarray:
    """Render a triangle soup to an RGB uint8 image [size, size, 3] (row 0 =
    top).

    vertices/normals: [N, 3] float32 triangle soup (N divisible by 3).
    camera_vp/light_vp: 4x4 projected view matrices (see render.camera).
    """
    vertices = np.ascontiguousarray(vertices, dtype=np.float32).reshape(-1, 3)
    normals = np.ascontiguousarray(normals, dtype=np.float32).reshape(-1, 3)
    camera_vp = np.ascontiguousarray(camera_vp, dtype=np.float32)
    light_vp = np.ascontiguousarray(light_vp, dtype=np.float32)
    light_vp_inv = np.ascontiguousarray(np.linalg.inv(light_vp.astype(np.float64)),
                                        dtype=np.float32)
    albedo_arr = np.asarray(albedo, dtype=np.float32)
    bg_arr = np.asarray(background, dtype=np.float32)
    out = np.empty((size, size, 3), dtype=np.uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    _rasterizer().rasterize_scene(
        vertices.ctypes.data_as(f32p), normals.ctypes.data_as(f32p),
        ctypes.c_long(len(vertices)),
        camera_vp.ctypes.data_as(f32p), light_vp.ctypes.data_as(f32p),
        light_vp_inv.ctypes.data_as(f32p),
        ctypes.c_float(float(ground_level)), ctypes.c_int(int(draw_floor)),
        albedo_arr.ctypes.data_as(f32p), bg_arr.ctypes.data_as(f32p),
        ctypes.c_int(size), ctypes.c_int(shadow_size),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
    )
    return out
