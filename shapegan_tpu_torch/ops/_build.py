"""Build and load the hand-written CUDA kernels under ``ops/csrc/``.

The ``.cu`` sources expose a plain C interface; ``nvcc`` compiles them for
Hopper (``sm_90a``), one process per source, all started together, and
links the objects into one shared library, loaded with ``ctypes``. The
build happens at first use, into ``ops/csrc/build/`` (git-ignored), under a
file lock so concurrent processes build once. The library's name carries a
hash of the sources and flags, so an edited source is rebuilt.

There is no fallback: when ``nvcc`` is missing or the build fails,
:func:`load` raises.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import threading

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(CSRC_DIR, "build")
SOURCES = (
    "sdf_grid.cu", "sdf_points.cu", "sdf_grid_bwd.cu", "sdf_trace.cu", "sdf_rowwise.cu",
    "sdf_rowwise_bwd.cu", "point_gen.cu",
)
HEADERS = ("sdf_trunk_sm90.cuh", "sdf_rows_sm90.cuh", "sdf_bwd_passes.cuh", "sdf_grid_bwd_sm90.cuh",
           "sdf_bwd_passes_sm90.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc_path() -> str:
    """The CUDA compiler: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                       "the CUDA kernels cannot be built")


def library_path() -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            digest.update(name.encode() + f.read())
    return os.path.join(BUILD_DIR, f"libsdf_kernels_{digest.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernels if this source revision has no library yet;
    returns the library's path. The compiler's output (with ``-Xptxas -v``:
    registers, shared memory and spills per kernel) is kept beside it in a
    ``.log`` file."""
    lib_path = library_path()
    if os.path.exists(lib_path):
        return lib_path
    nvcc = nvcc_path()
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.exists(lib_path):  # another process built it meanwhile
                return lib_path
            tmp_path = f"{lib_path}.tmp.{os.getpid()}"
            objects = [f"{tmp_path}.{name}.o" for name in SOURCES]
            compiles = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, os.path.join(CSRC_DIR, name)]
                        for name, obj in zip(SOURCES, objects)]
            procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True) for cmd in compiles]
            try:
                outputs = [proc.communicate(timeout=900)[0] for proc in procs]
            finally:
                for proc in procs:
                    if proc.poll() is None:
                        proc.kill()
                        proc.wait()
            log_text = "".join(outputs)
            failed = [(cmd, proc.returncode) for cmd, proc in zip(compiles, procs) if proc.returncode]
            if not failed:
                link = [nvcc, "-shared", "-o", tmp_path, *objects]
                proc = subprocess.run(link, capture_output=True, text=True, timeout=300)
                log_text += proc.stdout + proc.stderr
                if proc.returncode:
                    failed = [(link, proc.returncode)]
            for obj in objects:
                if os.path.exists(obj):
                    os.remove(obj)
            with open(lib_path[:-3] + ".log", "w") as log:
                log.write(log_text)
            if failed:
                cmd, code = failed[0]
                raise RuntimeError(f"nvcc failed ({code}):\n{' '.join(cmd)}\n{log_text}")
            os.replace(tmp_path, lib_path)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return lib_path


def build_log() -> str:
    """The compiler output of the current library's build, if it is kept."""
    path = library_path()[:-3] + ".log"
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


# The loader and the launch counts are shared by threads that drive one
# card each (render.raymarching.render_image_sequence).
_LOAD_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()
_COUNTED = set()   # every wrapper that has counted a launch


def count_launch(wrapper) -> None:
    """Add one to a kernel wrapper's ``launch_count`` (under a lock)."""
    with _COUNT_LOCK:
        wrapper.launch_count += 1
        _COUNTED.add(wrapper)


def launch_counts() -> dict:
    """Each wrapper that has counted a launch, with its ``launch_count``."""
    with _COUNT_LOCK:
        return {wrapper: wrapper.launch_count for wrapper in _COUNTED}


def add_launches(launches: dict) -> None:
    """Add to wrappers' ``launch_count`` (wrapper -> count): a CUDA graph's
    replay launches again what its capture counted."""
    with _COUNT_LOCK:
        for wrapper, n in launches.items():
            wrapper.launch_count += n


def load() -> ctypes.CDLL:
    """The kernel library with its C signatures declared (built if needed,
    once, whichever thread asks first)."""
    with _LOAD_LOCK:
        return _load()


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(build())
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.sdf_grid_forward.argtypes = [ptr] * 8 + [i32, i32, i32, ptr]
    lib.sdf_grid_forward.restype = i32
    lib.sdf_points_forward.argtypes = [ptr] * 9 + [i32, i32, ptr]
    lib.sdf_points_forward.restype = i32
    lib.sdf_grid_backward.argtypes = [ptr] * 18 + [i32, i32, i32, i32, ptr]
    lib.sdf_grid_backward.restype = i32
    lib.sdf_grid_backward_chunk_shapes.argtypes = [i32, i32]
    lib.sdf_grid_backward_chunk_shapes.restype = i32
    lib.sdf_grid_backward_scratch_bytes.argtypes = [i32, i32, i32]
    lib.sdf_grid_backward_scratch_bytes.restype = ctypes.c_longlong
    lib.sdf_grid_backward_offsets.argtypes = [i32, i32, i32, ctypes.POINTER(ctypes.c_longlong)]
    lib.sdf_grid_backward_offsets.restype = None
    lib.sdf_grid_backward_rows.argtypes = [ptr] * 10 + [i32, i32, i32, ptr]
    lib.sdf_grid_backward_rows.restype = i32
    lib.sdf_grid_backward_passes.argtypes = [ptr] * 13 + [i32, i32, i32, i32, ptr]
    lib.sdf_grid_backward_passes.restype = i32
    lib.sdf_grid_backward_passes_scratch_bytes.argtypes = [i32, i32]
    lib.sdf_grid_backward_passes_scratch_bytes.restype = ctypes.c_longlong
    lib.sdf_trace_steps.argtypes = [ptr] * 14 + [i32, i32, i32] + [ctypes.c_float] * 5 + [i32, ptr]
    lib.sdf_trace_steps.restype = i32
    lib.sdf_rowwise_forward.argtypes = [ptr] * 9 + [i32, i32, ptr]
    lib.sdf_rowwise_forward.restype = i32
    lib.sdf_rowwise_backward.argtypes = [ptr] * 17 + [i32, i32, ptr]
    lib.sdf_rowwise_backward.restype = i32
    lib.sdf_rowwise_backward_scratch_bytes.argtypes = [i32]
    lib.sdf_rowwise_backward_scratch_bytes.restype = ctypes.c_longlong
    lib.sdf_grid_stash_forward.argtypes = [ptr] * 9 + [i32, i32, i32, ptr]
    lib.sdf_grid_stash_forward.restype = i32
    lib.sdf_grid_stash_backward.argtypes = [ptr] * 19 + [i32, i32, i32, i32, ptr]
    lib.sdf_grid_stash_backward.restype = i32
    lib.point_gen_forward.argtypes = [ptr] * 11 + [i32, i32, i32, ptr]
    lib.point_gen_forward.restype = i32
    lib.sdf_error_string.argtypes = [i32]
    lib.sdf_error_string.restype = ctypes.c_char_p
    return lib


load.cache_clear = _load.cache_clear


def check(lib: ctypes.CDLL, name: str, code: int) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} "
                           f"({lib.sdf_error_string(code).decode()})")
