"""Builds the port's host C++ libraries (the rasterizer, the mesh SDF
engine) with the host compiler at first use.

A library is compiled from one source file into the git-ignored
``build/`` directory beside it, named ``<stem>_<hash>.so`` where the hash
covers the source and the flags, so an edited source gets a library of its
own. The build runs under a file lock (processes of a pool that start
together build once) into a temporary name moved over the target, so a
process that has the library mapped never sees it half written. A missing
or failing compiler raises: there is no fallback.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import subprocess

CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-Wall", "-shared")


def build_shared_library(source: str, stem: str, what: str) -> str:
    """Compile ``source`` into ``build/<stem>_<hash>.so`` beside it unless
    this source revision has a library already; returns the library's path.
    ``what`` names the library in errors."""
    build_dir = os.path.join(os.path.dirname(source), "build")
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    lib_path = os.path.join(build_dir, f"{stem}_{digest}.so")
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(build_dir, exist_ok=True)
    with open(os.path.join(build_dir, "build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not os.path.exists(lib_path):  # another process may have built it meanwhile
                tmp_path = f"{lib_path}.tmp.{os.getpid()}"
                cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, source, "-o", tmp_path]
                try:
                    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
                except OSError as exc:
                    raise RuntimeError(f"{what} cannot be built: {exc}") from exc
                if proc.returncode:
                    raise RuntimeError(f"{what} failed to build ({proc.returncode}):\n"
                                       f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
                os.replace(tmp_path, lib_path)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return lib_path
