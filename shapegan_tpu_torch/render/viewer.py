"""Interactive mesh and voxel viewer with shadow mapping (counterpart of
:mod:`shapegan_tpu.render.viewer`).

:class:`MeshRenderer` keeps the JAX viewer's scene state (rotation, model
size and colour, ground level, the triangle soup and its face normals),
meshes voxel volumes with the port's marching tetrahedra (on the volume's
device, then copied to the host), and draws the JAX viewer's pipeline: a
light-space depth pass into a 1024^2 shadow map, then the camera pass with
a 3 x 3 PCF shadow lookup, rim light and a floor darkened by the shadow.
Three backends share it, as in the JAX viewer:

* a pygame + PyOpenGL window, drawn by a render thread (``start_thread``):
  drag with the left button to rotate, ``r`` to reset the camera, F12 for
  a screenshot in ``screenshots/``;
* headless GL (:meth:`MeshRenderer.use_headless_gl`): the same shaders and
  draw calls in a surfaceless EGL context (Mesa), into an offscreen
  framebuffer;
* the C++ software rasterizer
  (:func:`shapegan_tpu_torch.render.software.render_scene`), the JAX
  viewer's route on a host without GL.

:meth:`MeshRenderer.get_image` reads the GL frame on the thread that owns
the GL context (the render thread's F12, or the caller of
:meth:`use_headless_gl`) and renders the software twin of the same scene
everywhere else. pygame and PyOpenGL are imported only when a window or a
headless context is asked for, so the module imports on hosts without
them; there the render thread prints "GL viewer disabled (...)" and ends,
and the scene state and the software ``get_image`` keep working. The card's
machine has neither OpenCV nor Pillow: ``get_image`` resizes with
:func:`shapegan_tpu_torch.util.resize_area` (OpenCV's ``INTER_AREA``
written out), and screenshots are written by
:func:`shapegan_tpu_torch.render.png.write_png`.
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np
import torch

from shapegan_tpu_torch.data.mesh_io import TriangleMesh
from shapegan_tpu_torch.ops.mesh_extract import extract_mesh
from shapegan_tpu_torch.render.binary_voxels import create_binary_voxel_mesh
from shapegan_tpu_torch.render.camera import get_camera_transform
from shapegan_tpu_torch.render.software import SHADOW_TEXTURE_SIZE, render_scene
from shapegan_tpu_torch.util import crop_image, ensure_directory, resize_area

DEFAULT_ROTATION = (147.0, 20.0)

_EGL_CONTEXT = None  # one surfaceless context per process


def _make_surfaceless_egl_context_current() -> None:
    """Create once, and make current on this thread, a surfaceless EGL
    context for desktop OpenGL (Mesa's display-less path). Raises on hosts
    without a working EGL stack."""
    global _EGL_CONTEXT
    import ctypes

    EGL_PLATFORM_SURFACELESS_MESA = 0x31DD
    EGL_SURFACE_TYPE = 0x3033
    EGL_RENDERABLE_TYPE = 0x3040
    EGL_OPENGL_BIT = 0x0008
    EGL_NONE = 0x3038
    EGL_OPENGL_API = 0x30A2
    EGL_NO_SURFACE = None

    egl = ctypes.CDLL("libEGL.so.1")
    egl.eglGetPlatformDisplay.restype = ctypes.c_void_p
    egl.eglGetPlatformDisplay.argtypes = [ctypes.c_uint, ctypes.c_void_p, ctypes.c_void_p]
    egl.eglInitialize.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
                                  ctypes.POINTER(ctypes.c_int)]
    egl.eglChooseConfig.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
                                    ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
                                    ctypes.POINTER(ctypes.c_int)]
    egl.eglCreateContext.restype = ctypes.c_void_p
    egl.eglCreateContext.argtypes = [ctypes.c_void_p] * 4
    egl.eglMakeCurrent.argtypes = [ctypes.c_void_p] * 4

    if _EGL_CONTEXT is not None:
        display, context = _EGL_CONTEXT
        if not egl.eglMakeCurrent(display, EGL_NO_SURFACE, EGL_NO_SURFACE, context):
            raise RuntimeError("headless GL: eglMakeCurrent failed on the process's context")
        return

    display = egl.eglGetPlatformDisplay(EGL_PLATFORM_SURFACELESS_MESA, None, None)
    if not display:
        raise RuntimeError("headless GL: no surfaceless EGL display")
    major, minor = ctypes.c_int(), ctypes.c_int()
    if not egl.eglInitialize(display, ctypes.byref(major), ctypes.byref(minor)):
        raise RuntimeError("headless GL: eglInitialize failed")
    attribs = (ctypes.c_int * 5)(EGL_SURFACE_TYPE, 0, EGL_RENDERABLE_TYPE, EGL_OPENGL_BIT,
                                 EGL_NONE)
    config, num = ctypes.c_void_p(), ctypes.c_int()
    if not egl.eglChooseConfig(display, attribs, ctypes.byref(config), 1, ctypes.byref(num)):
        raise RuntimeError("headless GL: eglChooseConfig failed")
    if not egl.eglBindAPI(EGL_OPENGL_API):
        raise RuntimeError("headless GL: desktop OpenGL API unavailable")
    context = egl.eglCreateContext(display, config if num.value else None, None, None)
    if not context:
        raise RuntimeError("headless GL: eglCreateContext failed")
    if not egl.eglMakeCurrent(display, EGL_NO_SURFACE, EGL_NO_SURFACE, context):
        raise RuntimeError("headless GL: eglMakeCurrent failed (no EGL_KHR_surfaceless_context?)")
    _EGL_CONTEXT = (display, context)


# The shading of render/csrc/rasterizer.cpp in GLSL: ambient 0.5, diffuse
# 0.5, specular 0.3 to the 20th power, rim light (1 - |n.z|)^4 * 0.3, a 3 x 3
# PCF over a bilinear blend of binary depth tests with a slope-scaled bias,
# and a floor blended from white toward 0.4 grey by the shadow.
VERTEX_SHADER = """
#version 130
uniform mat4 u_camera_vp;
uniform mat4 u_light_vp;
uniform mat4 u_light_vp_inverse;
uniform float u_y_offset;
in vec3 a_position;
in vec3 a_normal;
out vec3 v_normal;
out vec3 v_position;
out vec4 v_light_clip;
out vec3 v_light_position;

void main() {
    vec3 world = a_position;
    world.y += u_y_offset;
    gl_Position = u_camera_vp * vec4(world, 1.0);
    v_position = gl_Position.xyz;
    v_light_clip = u_light_vp * vec4(world, 1.0);
    // The light's position: its forward axis through the inverse light
    // transform, then into the camera's clip space.
    v_light_position = (u_camera_vp * u_light_vp_inverse * vec4(0.0, 0.0, -1.0, 1.0)).xyz;
    v_normal = (u_camera_vp * vec4(a_normal, 0.0)).xyz;
}
"""

FRAGMENT_SHADER = """
#version 130
uniform sampler2D u_depth_map;
uniform float u_floor_flag;
uniform vec3 u_base_color;
in vec3 v_normal;
in vec3 v_position;
in vec4 v_light_clip;
in vec3 v_light_position;
out vec4 out_color;

const float AMBIENT = 0.5;
const float DIFFUSE = 0.5;
const float SPECULAR = 0.3;
const float SPECULAR_POWER = 20.0;
const float RIM_POWER = 4.0;
const float RIM_STRENGTH = 0.3;

// 1 where the stored light-space depth at uv lies in front of depth_ref.
float depth_test(vec2 uv, float depth_ref) {
    return depth_ref > texture(u_depth_map, uv).r ? 1.0 : 0.0;
}

// The four binary tests around uv, blended bilinearly.
float occlusion_bilinear(vec2 uv, float depth_ref, float map_size) {
    float step = 1.0 / map_size;
    vec2 scaled = uv * map_size + 0.5;
    vec2 w = fract(scaled);
    vec2 base = floor(scaled) / map_size;
    float s00 = depth_test(base, depth_ref);
    float s01 = depth_test(base + vec2(0.0, step), depth_ref);
    float s10 = depth_test(base + vec2(step, 0.0), depth_ref);
    float s11 = depth_test(base + vec2(step, step), depth_ref);
    return mix(mix(s00, s01, w.y), mix(s10, s11, w.y), w.x);
}

// A 3 x 3 percentage-closer filter of the blended tests, with a
// slope-scaled depth bias.
float shadow_factor(vec4 light_clip, float n_dot_l) {
    vec3 ndc = light_clip.xyz / light_clip.w;
    vec3 map_coords = ndc * 0.5 + 0.5;
    if (map_coords.z > 1.0) {
        return 0.0;
    }
    float bias = max(0.002 * (1.0 - n_dot_l), 0.001) / light_clip.w;
    float depth_ref = map_coords.z - bias;
    float map_size = float(textureSize(u_depth_map, 0).x);
    float total = 0.0;
    for (int dx = -1; dx <= 1; dx++) {
        for (int dy = -1; dy <= 1; dy++) {
            vec2 tap = map_coords.xy + vec2(dx, dy) / map_size;
            total += occlusion_bilinear(tap, depth_ref, map_size);
        }
    }
    return clamp(total / 9.0, 0.0, 1.0);
}

void main() {
    vec3 n = normalize(v_normal);
    vec3 to_eye = normalize(-v_position);
    vec3 to_light = normalize(v_light_position - v_position);
    vec3 bounce = -normalize(reflect(to_light, n));
    float n_dot_l = clamp(dot(n, to_light), 0.0, 1.0);

    float shadow = shadow_factor(v_light_clip, n_dot_l);
    float lit = 1.0 - shadow;
    float rim = RIM_STRENGTH * pow(1.0 - clamp(-n.z, 0.0, 1.0), RIM_POWER);
    float glint = SPECULAR * pow(max(0.0, dot(bounce, to_eye)), SPECULAR_POWER);

    vec3 shade = u_base_color * (AMBIENT + DIFFUSE * n_dot_l * lit) + vec3(glint * lit + rim);
    if (u_floor_flag == 1.0) {
        // The floor: white where lit, dim grey where shadowed.
        shade = mix(vec3(1.0), vec3(0.8) * AMBIENT, shadow);
    }
    out_color = vec4(shade, 1.0);
}
"""

DEPTH_VERTEX_SHADER = """
#version 130
uniform mat4 u_camera_vp;
in vec3 a_position;
void main() { gl_Position = u_camera_vp * vec4(a_position, 1.0); }
"""

DEPTH_FRAGMENT_SHADER = """
#version 130
out vec4 out_color;
void main() { out_color = vec4(1.0); }
"""


def _text(log) -> str:
    """A shader or program log (PyOpenGL gives bytes or str)."""
    return log.decode() if isinstance(log, bytes) else str(log)


class MeshRenderer:
    """One viewer: set a mesh or voxels, look at them in its window (a
    render thread with ``start_thread``) or read frames with
    :meth:`get_image`."""

    def __init__(self, size: int = 800, start_thread: bool = True,
                 background_color=(1, 1, 1, 1)):
        self.size = size
        self.background_color = background_color
        self.rotation = list(DEFAULT_ROTATION)
        self.model_size = 1.0
        self.model_color = (0.8, 0.1, 0.1)
        self.ground_level = -1.0
        self._lock = threading.Lock()
        self._vertices = np.zeros((0, 3), np.float32)  # triangle soup
        self._normals = np.zeros((0, 3), np.float32)
        self._dirty = False
        self._running = True
        self._vertex_count = 0
        self._window = None      # set once a GL context draws this viewer
        self._gl_thread = None   # the thread whose GL context that is
        self._target_fbo = 0
        self.thread = None
        if start_thread:
            self.thread = threading.Thread(target=self._run, daemon=True)
            self.thread.start()

    # ----------------------------------------------------------- the scene

    def set_mesh(self, mesh, center_and_scale: bool = False) -> None:
        """Show a :class:`TriangleMesh` (None clears the scene), framed at
        the model size 1.08; ``center_and_scale`` centres its bounding box
        and scales it into the unit sphere."""
        if mesh is None:
            with self._lock:
                self._vertices = np.zeros((0, 3), np.float32)
                self._normals = np.zeros((0, 3), np.float32)
                self._dirty = True
            return
        tri = mesh.triangles.reshape(-1, 3).astype(np.float32)
        if center_and_scale and tri.size:
            tri = tri - (tri.min(axis=0) + tri.max(axis=0))[None, :] / 2.0
            tri = tri / max(float(np.linalg.norm(tri, axis=1).max()), 1e-9)
        normals = np.repeat(mesh.face_normals, 3, axis=0).astype(np.float32)
        with self._lock:
            self._vertices = tri
            self._normals = normals
            self.model_size = 1.08
            self.ground_level = float(tri[:, 1].min()) if tri.size else -1.0
            self._dirty = True

    def set_voxels(self, voxels, use_marching_cubes: bool = True, level: float = 0.0) -> None:
        """Show an SDF volume [R, R, R] (a tensor, meshed on its device, or
        an array, meshed on the CPU) placed in [-1, 1]^3 and framed at the
        model size 1.4: its ``level`` iso-surface, padded with +1, or with
        ``use_marching_cubes=False`` the cubes of its voxels below
        ``level``."""
        voxels = torch.as_tensor(voxels, dtype=torch.float32).detach()
        res = voxels.shape[0]
        if use_marching_cubes:
            padded = torch.nn.functional.pad(voxels, (1,) * 6, value=1.0)
            vertices, faces = extract_mesh(padded, level=level, spacing=2.0 / res)
            mesh = TriangleMesh(vertices - 1.0 - 1.0 / res, faces)
        else:
            mesh = create_binary_voxel_mesh(voxels, threshold=level)
            mesh = TriangleMesh(mesh.vertices * (2.0 / res) - 1.0, mesh.faces)
        self.set_mesh(mesh)
        self.model_size = 1.4

    def scene(self):
        """(vertices, normals) of the current triangle soup."""
        with self._lock:
            return self._vertices, self._normals

    def stop(self) -> None:
        """End the render thread (its window closes)."""
        self._running = False
        if self.thread is not None and self.thread.is_alive():
            self.thread.join(timeout=2.0)

    def _matrices(self):
        """(camera VP, light VP) for the current rotation: the camera at
        twice the model size, the light at distance 6 and pitch 50, its yaw
        following the camera's."""
        camera_vp = get_camera_transform(self.model_size * 2.0, self.rotation[0], self.rotation[1],
                                         project=True)
        light_vp = get_camera_transform(6.0, self.rotation[0], 50.0, project=True)
        return camera_vp, light_vp

    # -------------------------------------------------------------- GL path

    @staticmethod
    def _compile_program(GL, vertex_source: str, fragment_source: str):
        program = GL.glCreateProgram()
        for source, kind in ((vertex_source, GL.GL_VERTEX_SHADER),
                             (fragment_source, GL.GL_FRAGMENT_SHADER)):
            shader = GL.glCreateShader(kind)
            GL.glShaderSource(shader, source)
            GL.glCompileShader(shader)
            if not GL.glGetShaderiv(shader, GL.GL_COMPILE_STATUS):
                raise RuntimeError(_text(GL.glGetShaderInfoLog(shader)))
            GL.glAttachShader(program, shader)
        GL.glLinkProgram(program)
        if not GL.glGetProgramiv(program, GL.GL_LINK_STATUS):
            raise RuntimeError(_text(GL.glGetProgramInfoLog(program)))
        return program

    def _init_gl(self) -> None:
        """The window and its GL objects, on the calling thread."""
        import pygame
        from OpenGL import GL

        pygame.init()
        pygame.display.set_mode((self.size, self.size), pygame.OPENGL | pygame.DOUBLEBUF)
        pygame.display.set_caption("shapegan_tpu_torch viewer")
        self._init_gl_objects(GL)
        self._gl_thread = threading.get_ident()
        self._window = True

    def use_headless_gl(self) -> None:
        """Draw with the GL pipeline (the same shaders and draw calls) in a
        surfaceless EGL context made current on this thread, into an
        offscreen framebuffer: from here on :meth:`get_image` on this
        thread reads GL frames. Raises where there is no EGL or GL stack,
        or where PyOpenGL was imported with another platform than EGL."""
        import sys

        if "OpenGL" not in sys.modules:
            # PyOpenGL picks its function loader when first imported; without
            # a display only the EGL loader works.
            os.environ.setdefault("PYOPENGL_PLATFORM", "egl")
        else:
            from OpenGL.platform import PLATFORM

            if "EGL" not in type(PLATFORM).__name__:
                raise RuntimeError(
                    "headless GL needs PyOpenGL's EGL loader, but OpenGL was already imported "
                    f"with {type(PLATFORM).__name__}; set PYOPENGL_PLATFORM=egl before the "
                    "first OpenGL import")
        _make_surfaceless_egl_context_current()
        from OpenGL import GL

        self._init_gl_objects(GL)
        # A surfaceless context has no default framebuffer.
        fbo = GL.glGenFramebuffers(1)
        GL.glBindFramebuffer(GL.GL_FRAMEBUFFER, fbo)
        for storage, attachment in ((GL.GL_RGB8, GL.GL_COLOR_ATTACHMENT0),
                                    (GL.GL_DEPTH_COMPONENT24, GL.GL_DEPTH_ATTACHMENT)):
            renderbuffer = GL.glGenRenderbuffers(1)
            GL.glBindRenderbuffer(GL.GL_RENDERBUFFER, renderbuffer)
            GL.glRenderbufferStorage(GL.GL_RENDERBUFFER, storage, self.size, self.size)
            GL.glFramebufferRenderbuffer(GL.GL_FRAMEBUFFER, attachment, GL.GL_RENDERBUFFER,
                                         renderbuffer)
        if GL.glCheckFramebufferStatus(GL.GL_FRAMEBUFFER) != GL.GL_FRAMEBUFFER_COMPLETE:
            raise RuntimeError("headless GL: offscreen framebuffer incomplete")
        self._target_fbo = int(fbo)
        self._gl_thread = threading.get_ident()
        self._window = True

    def _init_gl_objects(self, GL) -> None:
        """The GL state of both GL routes: the two programs, the shadow
        map's texture and framebuffer, the vertex buffers and the floor."""
        self._target_fbo = 0
        self._program = self._compile_program(GL, VERTEX_SHADER, FRAGMENT_SHADER)
        self._depth_program = self._compile_program(GL, DEPTH_VERTEX_SHADER, DEPTH_FRAGMENT_SHADER)

        self._shadow_texture = GL.glGenTextures(1)
        GL.glBindTexture(GL.GL_TEXTURE_2D, self._shadow_texture)
        GL.glTexImage2D(GL.GL_TEXTURE_2D, 0, GL.GL_DEPTH_COMPONENT, SHADOW_TEXTURE_SIZE,
                        SHADOW_TEXTURE_SIZE, 0, GL.GL_DEPTH_COMPONENT, GL.GL_FLOAT, None)
        GL.glTexParameteri(GL.GL_TEXTURE_2D, GL.GL_TEXTURE_MAG_FILTER, GL.GL_NEAREST)
        GL.glTexParameteri(GL.GL_TEXTURE_2D, GL.GL_TEXTURE_MIN_FILTER, GL.GL_NEAREST)
        # Clamped to the edge, as the software rasterizer reads its map.
        GL.glTexParameteri(GL.GL_TEXTURE_2D, GL.GL_TEXTURE_WRAP_S, GL.GL_CLAMP_TO_EDGE)
        GL.glTexParameteri(GL.GL_TEXTURE_2D, GL.GL_TEXTURE_WRAP_T, GL.GL_CLAMP_TO_EDGE)
        GL.glBindTexture(GL.GL_TEXTURE_2D, 0)
        self._shadow_fbo = GL.glGenFramebuffers(1)

        self._vbo_positions = GL.glGenBuffers(1)
        self._vbo_normals = GL.glGenBuffers(1)
        s = 6.0  # the floor quad's half size
        floor = np.array([[-s, 0, -s], [-s, 0, s], [s, 0, s], [-s, 0, -s], [s, 0, s], [s, 0, -s]],
                         np.float32)
        floor_normals = np.tile(np.array([[0, 1, 0]], np.float32), (6, 1))
        self._vbo_floor_positions = GL.glGenBuffers(1)
        self._vbo_floor_normals = GL.glGenBuffers(1)
        for vbo, data in ((self._vbo_floor_positions, floor),
                          (self._vbo_floor_normals, floor_normals)):
            GL.glBindBuffer(GL.GL_ARRAY_BUFFER, vbo)
            GL.glBufferData(GL.GL_ARRAY_BUFFER, data.nbytes, data, GL.GL_STATIC_DRAW)
        GL.glEnable(GL.GL_DEPTH_TEST)
        self._dirty = True  # upload the scene set before the context existed

    def _upload(self) -> None:
        """The latest triangle soup to the vertex buffers, when it changed."""
        from OpenGL import GL

        with self._lock:
            if not self._dirty:
                return
            vertices, normals = self._vertices, self._normals
            self._dirty = False
        GL.glBindBuffer(GL.GL_ARRAY_BUFFER, self._vbo_positions)
        GL.glBufferData(GL.GL_ARRAY_BUFFER, vertices.nbytes, vertices, GL.GL_DYNAMIC_DRAW)
        GL.glBindBuffer(GL.GL_ARRAY_BUFFER, self._vbo_normals)
        GL.glBufferData(GL.GL_ARRAY_BUFFER, normals.nbytes, normals, GL.GL_DYNAMIC_DRAW)
        self._vertex_count = len(vertices)

    @staticmethod
    def _bind_attributes(program, vbo_positions, vbo_normals, use_normals: bool = True) -> None:
        from OpenGL import GL

        location = GL.glGetAttribLocation(program, "a_position")
        GL.glBindBuffer(GL.GL_ARRAY_BUFFER, vbo_positions)
        GL.glEnableVertexAttribArray(location)
        GL.glVertexAttribPointer(location, 3, GL.GL_FLOAT, GL.GL_FALSE, 0, None)
        if use_normals:
            location = GL.glGetAttribLocation(program, "a_normal")
            if location >= 0:
                GL.glBindBuffer(GL.GL_ARRAY_BUFFER, vbo_normals)
                GL.glEnableVertexAttribArray(location)
                GL.glVertexAttribPointer(location, 3, GL.GL_FLOAT, GL.GL_FALSE, 0, None)

    def _draw(self) -> None:
        """One frame: the light's depth pass into the shadow map, then the
        camera pass (model, then floor) into the window or the offscreen
        framebuffer."""
        from OpenGL import GL

        self._upload()
        camera_vp, light_vp = self._matrices()
        camera_vp = camera_vp.astype(np.float32)
        light_vp32 = light_vp.astype(np.float32)
        light_vp_inverse = np.linalg.inv(light_vp).astype(np.float32)

        GL.glBindFramebuffer(GL.GL_FRAMEBUFFER, self._shadow_fbo)
        GL.glFramebufferTexture2D(GL.GL_FRAMEBUFFER, GL.GL_DEPTH_ATTACHMENT, GL.GL_TEXTURE_2D,
                                  self._shadow_texture, 0)
        GL.glDrawBuffer(GL.GL_NONE)
        GL.glReadBuffer(GL.GL_NONE)
        GL.glViewport(0, 0, SHADOW_TEXTURE_SIZE, SHADOW_TEXTURE_SIZE)
        GL.glClear(GL.GL_DEPTH_BUFFER_BIT)
        if self._vertex_count:
            GL.glUseProgram(self._depth_program)
            GL.glUniformMatrix4fv(GL.glGetUniformLocation(self._depth_program, "u_camera_vp"), 1,
                                  GL.GL_TRUE, light_vp32)
            self._bind_attributes(self._depth_program, self._vbo_positions, self._vbo_normals,
                                  use_normals=False)
            GL.glDrawArrays(GL.GL_TRIANGLES, 0, self._vertex_count)

        GL.glBindFramebuffer(GL.GL_FRAMEBUFFER, self._target_fbo)
        GL.glViewport(0, 0, self.size, self.size)
        GL.glClearColor(*self.background_color)
        GL.glClear(GL.GL_COLOR_BUFFER_BIT | GL.GL_DEPTH_BUFFER_BIT)
        if self._vertex_count == 0:
            return
        program = self._program
        GL.glUseProgram(program)
        for name, value in (("u_camera_vp", camera_vp), ("u_light_vp", light_vp32),
                            ("u_light_vp_inverse", light_vp_inverse)):
            GL.glUniformMatrix4fv(GL.glGetUniformLocation(program, name), 1, GL.GL_TRUE, value)
        GL.glActiveTexture(GL.GL_TEXTURE1)
        GL.glBindTexture(GL.GL_TEXTURE_2D, self._shadow_texture)
        GL.glUniform1i(GL.glGetUniformLocation(program, "u_depth_map"), 1)

        GL.glUniform1f(GL.glGetUniformLocation(program, "u_floor_flag"), 0.0)
        GL.glUniform1f(GL.glGetUniformLocation(program, "u_y_offset"), 0.0)
        GL.glUniform3f(GL.glGetUniformLocation(program, "u_base_color"), *self.model_color)
        self._bind_attributes(program, self._vbo_positions, self._vbo_normals)
        GL.glDrawArrays(GL.GL_TRIANGLES, 0, self._vertex_count)

        GL.glUniform1f(GL.glGetUniformLocation(program, "u_floor_flag"), 1.0)
        GL.glUniform1f(GL.glGetUniformLocation(program, "u_y_offset"), self.ground_level)
        self._bind_attributes(program, self._vbo_floor_positions, self._vbo_floor_normals)
        GL.glDrawArrays(GL.GL_TRIANGLES, 0, 6)

    def _run(self) -> None:
        """The render thread: open the window, then handle its events and
        draw about 60 frames a second until :meth:`stop` or the window is
        closed. Where pygame, PyOpenGL, a display or a working GL context is
        missing (at the start, or at a later frame) it prints why and ends;
        the viewer goes on without a window."""
        try:
            import pygame

            self._init_gl()
            self._loop(pygame)
        except Exception as e:
            print(f"GL viewer disabled ({type(e).__name__}: {e})", flush=True)
            self._window = self._gl_thread = None
            self._running = False
            return
        pygame.quit()

    def _loop(self, pygame) -> None:
        """The window's event loop: a left-button drag rotates, ``r``
        resets the camera, F12 saves a screenshot, closing the window ends
        it."""
        dragging = False
        while self._running:
            for event in pygame.event.get():
                if event.type == pygame.QUIT:
                    self._running = False
                elif event.type == pygame.MOUSEBUTTONDOWN and event.button == 1:
                    dragging = True
                elif event.type == pygame.MOUSEBUTTONUP and event.button == 1:
                    dragging = False
                elif event.type == pygame.MOUSEMOTION and dragging:
                    self.rotation[0] += event.rel[0] * 0.3
                    self.rotation[1] = float(np.clip(self.rotation[1] + event.rel[1] * 0.3, -90, 90))
                elif event.type == pygame.KEYDOWN:
                    if event.key == pygame.K_r:
                        self.rotation = list(DEFAULT_ROTATION)
                    elif event.key == pygame.K_F12:
                        self.save_screenshot()
            self._draw()
            pygame.display.flip()
            time.sleep(1 / 60)

    # ------------------------------------------------------------ the image

    def _get_image_gl(self) -> np.ndarray:
        """Draw a frame and read it back (on the GL context's thread)."""
        from OpenGL import GL

        self._draw()
        GL.glBindFramebuffer(GL.GL_FRAMEBUFFER, self._target_fbo)
        data = GL.glReadPixels(0, 0, self.size, self.size, GL.GL_RGB, GL.GL_UNSIGNED_BYTE)
        return np.frombuffer(data, np.uint8).reshape(self.size, self.size, 3)[::-1]

    def _get_image_software(self) -> np.ndarray:
        """The same scene through the C++ rasterizer."""
        vertices, normals = self.scene()
        camera_vp, light_vp = self._matrices()
        return render_scene(vertices, normals, camera_vp, light_vp, size=self.size,
                            ground_level=self.ground_level, albedo=self.model_color,
                            background=self.background_color[:3])

    def get_image(self, crop: bool = False, output_size: int = None, greyscale: bool = False):
        """The current frame as a uint8 array [size, size, 3] (or [size,
        size] with ``greyscale``): read from GL on the thread whose context
        draws this viewer, rendered by the software twin elsewhere; cropped
        to its content with ``crop``, resized to ``output_size`` by
        :func:`resize_area`."""
        if self._window is not None and self._gl_thread == threading.get_ident():
            image = self._get_image_gl()
        else:
            image = self._get_image_software()
        if greyscale:
            image = image.mean(axis=2).astype(np.uint8)
        if crop:
            image = crop_image(image, background=255)
        if output_size is not None and output_size != image.shape[0]:
            image = resize_area(image, output_size)
        return image

    def save_screenshot(self, filename: str = None) -> str:
        """The current frame as a PNG, by default the first free
        ``screenshots/screenshot-<i>.png``. The file is written under a
        temporary name and renamed into place, so a reader never sees it
        half written."""
        ensure_directory("screenshots")
        if filename is None:
            index = 0
            while os.path.exists(f"screenshots/screenshot-{index}.png"):
                index += 1
            filename = f"screenshots/screenshot-{index}.png"
        from shapegan_tpu_torch.render.png import write_png

        partial = f"{filename}.{os.getpid()}.{threading.get_ident()}.part"
        write_png(partial, self.get_image())
        os.replace(partial, filename)
        print(f"Screenshot saved to {filename}.")
        return filename
