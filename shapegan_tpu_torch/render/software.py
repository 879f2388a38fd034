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
import fcntl
import functools
import hashlib
import os
import subprocess

import numpy as np

SHADOW_TEXTURE_SIZE = 1024
CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(CSRC_DIR, "build")
SOURCE = os.path.join(CSRC_DIR, "rasterizer.cpp")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-Wall", "-shared")


def build_rasterizer() -> str:
    """Compile the rasterizer if this source revision has no library yet
    (the name carries a hash of the source and flags), under a file lock so
    concurrent processes build once; returns the library's path. Raises when
    the compiler is missing or fails: there is no fallback."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    lib_path = os.path.join(BUILD_DIR, f"librasterizer_{digest}.so")
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not os.path.exists(lib_path):  # another process may have built it meanwhile
                tmp_path = f"{lib_path}.tmp.{os.getpid()}"
                cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, SOURCE, "-o", tmp_path]
                try:
                    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
                except OSError as exc:
                    raise RuntimeError(f"the C++ rasterizer cannot be built: {exc}") from exc
                if proc.returncode:
                    raise RuntimeError(f"the C++ rasterizer failed to build ({proc.returncode}):\n"
                                       f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
                os.replace(tmp_path, lib_path)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return lib_path


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
