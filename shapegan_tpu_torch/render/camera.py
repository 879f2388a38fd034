"""Camera math (a jax-free copy of :mod:`shapegan_tpu.render.camera`, whose
package imports the raymarcher).

The projection matrix corresponds to a 60° vertical FOV with near=0.1,
far=10; camera transforms are translate(-distance) ∘ rotX ∘ rotY, optionally
projected.
"""

from __future__ import annotations

import math

import numpy as np


def projection_matrix(fov_degrees: float = 60.0, near: float = 0.1, far: float = 10.0) -> np.ndarray:
    f = 1.0 / math.tan(math.radians(fov_degrees) / 2.0)
    a = -(far + near) / (far - near)
    b = -2.0 * far * near / (far - near)
    return np.array(
        [[f, 0, 0, 0],
         [0, f, 0, 0],
         [0, 0, a, b],
         [0, 0, -1, 0]],
        dtype=np.float64,
    )


PROJECTION_MATRIX = projection_matrix()


def rotation_matrix(angle_degrees: float, axis: str = "y") -> np.ndarray:
    """4x4 rotation about a principal axis."""
    t = math.radians(angle_degrees)
    c, s = math.cos(t), math.sin(t)
    m = np.identity(4)
    if axis == "x":
        m[1:3, 1:3] = [[c, -s], [s, c]]
    elif axis == "y":
        m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, s, -s, c
    elif axis == "z":
        m[0:2, 0:2] = [[c, -s], [s, c]]
    else:
        raise ValueError(f"unknown axis {axis}")
    return m


def get_camera_transform(
    camera_distance: float, rotation_y: float, rotation_x: float = 0.0, project: bool = False
) -> np.ndarray:
    transform = np.identity(4)
    transform[2, 3] = -camera_distance
    transform = transform @ rotation_matrix(rotation_x, "x") @ rotation_matrix(rotation_y, "y")
    if project:
        transform = PROJECTION_MATRIX @ transform
    return transform


def camera_position_from_transform(transform: np.ndarray) -> np.ndarray:
    """World-space camera origin: inverse(transform) applied to the origin."""
    return (np.linalg.inv(transform) @ np.array([0.0, 0.0, 0.0, 1.0]))[:3]
