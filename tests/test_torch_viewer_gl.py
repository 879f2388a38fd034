"""The port's GL viewer (``render/viewer.py``) and ``train.common.make_viewer``:
the headless-EGL frame against the software twin and against the JAX
viewer's GL frame of the same scene (in a fresh interpreter, so PyOpenGL
takes its EGL loader whatever this process imported before), the window's
event loop on SDL's dummy video backend (drag, ``r``, F12), the viewer
without pygame, ``make_viewer``'s rules, and the teardown of the process
group a ``torch.distributed.run`` launch starts."""

import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch.distributed as dist

from shapegan_tpu_torch.data.mesh_io import TriangleMesh
from shapegan_tpu_torch.parallel import mesh as mesh_lib
from shapegan_tpu_torch.render import png
from shapegan_tpu_torch.render.viewer import MeshRenderer
from shapegan_tpu_torch.train import common

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAINERS = ["autoencoder", "classifier", "gan", "hybrid_gan", "hybrid_progressive_gan",
            "hybrid_wgan", "point_gan", "point_gan_ref", "sdf_autodecoder", "wgan"]

# A box hovering over the floor, drawn by both packages' viewers at 200^2 in
# a surfaceless EGL context; the frames go back through an .npz.
GL_SCRIPT = r"""
import sys
import numpy as np

CORNERS = np.array([[x, y, z] for x in (-0.4, 0.4) for y in (-0.4, 0.4) for z in (-0.4, 0.4)],
                   np.float32)
FACES = np.array([(0, 1, 3), (0, 3, 2), (4, 6, 7), (4, 7, 5), (0, 4, 5), (0, 5, 1),
                  (2, 3, 7), (2, 7, 6), (0, 2, 6), (0, 6, 4), (1, 5, 7), (1, 7, 3)], np.int32)


def frames(viewer_module, mesh_module):
    viewer = viewer_module.MeshRenderer(size=200, start_thread=False)
    viewer.use_headless_gl()
    viewer.set_mesh(mesh_module.TriangleMesh(CORNERS, FACES))
    viewer.ground_level = -0.8
    return viewer.get_image(), viewer._get_image_software()


from shapegan_tpu_torch.data import mesh_io as port_mesh
from shapegan_tpu_torch.render import viewer as port_viewer
from shapegan_tpu.data import mesh_io as jax_mesh
from shapegan_tpu.render import viewer as jax_viewer

port_gl, port_sw = frames(port_viewer, port_mesh)
jax_gl, _ = frames(jax_viewer, jax_mesh)
np.savez(sys.argv[1], port_gl=port_gl, port_sw=port_sw, jax_gl=jax_gl)
"""

# One rank of a torch.distributed.run launch: the classifier's entry point,
# then whether a process group is left.
LAUNCH_SCRIPT = r"""
import os
import torch.distributed as dist
from shapegan_tpu_torch.core.config import parse_cli
from shapegan_tpu_torch.train import classifier

os.chdir(os.environ["WORKDIR"])
classifier.train(parse_cli(["cpu", "synthetic=1", "batch_size=4", "epochs=1"]))
print(f"rank {os.environ['RANK']} left a process group: {dist.is_initialized()}", flush=True)
"""


def _box():
    corners = np.array([[x, y, z] for x in (-0.4, 0.4) for y in (-0.4, 0.4) for z in (-0.4, 0.4)],
                       np.float32)
    faces = np.array([(0, 1, 3), (0, 3, 2), (4, 6, 7), (4, 7, 5), (0, 4, 5), (0, 5, 1),
                      (2, 3, 7), (2, 7, 6), (0, 2, 6), (0, 6, 4), (1, 5, 7), (1, 7, 3)], np.int32)
    return TriangleMesh(corners, faces)


def _red(image) -> int:
    return int(((image[:, :, 0].astype(int) - image[:, :, 2].astype(int)) > 40).sum())


def _env(**extra) -> dict:
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.update(extra)
    return env


@pytest.fixture(scope="module")
def gl_frames(tmp_path_factory):
    out = tmp_path_factory.mktemp("gl") / "frames.npz"
    proc = subprocess.run([sys.executable, "-c", GL_SCRIPT, str(out)], capture_output=True,
                          text=True, timeout=300, env=_env(PYOPENGL_PLATFORM="egl"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(out) as data:
        return {k: data[k] for k in data.files}


def test_headless_gl_frame_matches_the_software_twin(gl_frames):
    """The GL pipeline (the shaders, both passes, the shadow map's
    framebuffer) in a surfaceless EGL context draws the box (red pixels),
    within the JAX test's bound of the C++ rasterizer's frame of the same
    scene (rasterization edge rules: a few pixels differ by more than 16)."""
    gl, sw = gl_frames["port_gl"], gl_frames["port_sw"]
    assert gl.shape == sw.shape == (200, 200, 3)
    assert _red(gl) > 1000
    diff = np.abs(gl.astype(int) - sw.astype(int))
    assert diff.mean() < 1.0 and (diff > 16).mean() < 0.01, diff.mean()


def test_headless_gl_frame_matches_the_jax_viewer(gl_frames):
    """The port's GL frame against the JAX viewer's GL frame of the same
    scene, within the same bound."""
    diff = np.abs(gl_frames["port_gl"].astype(int) - gl_frames["jax_gl"].astype(int))
    assert _red(gl_frames["jax_gl"]) > 1000
    assert diff.mean() < 1.0 and (diff > 16).mean() < 0.01, diff.mean()


def _wait_until(cond, timeout: float = 20.0, what: str = "") -> None:
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def test_window_event_loop_on_sdl_dummy_video(monkeypatch, tmp_path):
    """The render thread's event loop (drag to rotate, ``r`` to reset, F12
    for a screenshot, closing the window ends it) on SDL's dummy video
    backend, which has no GL: the window opens without OpenGL, a frame
    draws nothing, and the frames read on the window's thread come from
    the software twin. The screenshot appears whole (written under another
    name, then renamed)."""
    import pygame

    monkeypatch.setenv("SDL_VIDEODRIVER", "dummy")
    monkeypatch.chdir(tmp_path)

    def dummy_window(self):
        pygame.init()
        pygame.display.set_mode((self.size, self.size))
        self._gl_thread = threading.get_ident()
        self._window = True

    monkeypatch.setattr(MeshRenderer, "_init_gl", dummy_window)
    monkeypatch.setattr(MeshRenderer, "_draw", lambda self: None)
    monkeypatch.setattr(MeshRenderer, "_get_image_gl", MeshRenderer._get_image_software)
    monkeypatch.setattr(pygame.display, "flip", lambda: None)

    viewer = MeshRenderer(size=96, start_thread=True)
    try:
        viewer.set_mesh(_box())
        _wait_until(lambda: viewer._window is not None, what="the window")
        start = list(viewer.rotation)
        pygame.event.post(pygame.event.Event(pygame.MOUSEBUTTONDOWN, button=1, pos=(10, 10)))
        pygame.event.post(pygame.event.Event(pygame.MOUSEMOTION, rel=(40, 20), pos=(50, 30),
                                             buttons=(1, 0, 0)))
        pygame.event.post(pygame.event.Event(pygame.MOUSEBUTTONUP, button=1, pos=(50, 30)))
        _wait_until(lambda: viewer.rotation != start, what="the drag")
        assert viewer.rotation == pytest.approx([start[0] + 40 * 0.3, start[1] + 20 * 0.3])

        settled = list(viewer.rotation)  # motion without a button held rotates nothing
        pygame.event.post(pygame.event.Event(pygame.MOUSEMOTION, rel=(25, 25), pos=(75, 55),
                                             buttons=(0, 0, 0)))
        time.sleep(0.2)
        assert viewer.rotation == settled

        pygame.event.post(pygame.event.Event(pygame.KEYDOWN, key=pygame.K_r))
        _wait_until(lambda: viewer.rotation == start, what="the reset")

        pygame.event.post(pygame.event.Event(pygame.KEYDOWN, key=pygame.K_F12))
        shot = tmp_path / "screenshots" / "screenshot-0.png"
        _wait_until(shot.exists, what="the F12 screenshot")
        image = png.read_png(str(shot))
        assert image.shape == (96, 96, 3) and _red(image) > 50
        np.testing.assert_array_equal(image, viewer._get_image_software())

        pygame.event.post(pygame.event.Event(pygame.QUIT))
        _wait_until(lambda: not viewer.thread.is_alive(), what="the loop's end")
    finally:
        viewer.stop()
    assert os.listdir(tmp_path / "screenshots") == ["screenshot-0.png"]


def test_make_viewer_rules(monkeypatch):
    """None under ``nogui`` and on a rank that does not write; a viewer
    otherwise, and None with the JAX line where one cannot be made."""
    assert common.make_viewer(True) is None
    monkeypatch.setattr(common, "is_writer", lambda: False)
    assert common.make_viewer(False) is None
    monkeypatch.setattr(common, "is_writer", lambda: True)
    monkeypatch.setattr("shapegan_tpu_torch.render.viewer.MeshRenderer.__init__",
                        lambda self: (_ for _ in ()).throw(OSError("no screen")))
    assert common.make_viewer(False) is None


def test_viewer_without_pygame(monkeypatch, capsys):
    """With pygame missing the render thread prints the JAX "GL viewer
    disabled" line and ends; the viewer still meshes volumes and renders
    them."""
    monkeypatch.setitem(sys.modules, "pygame", None)
    viewer = common.make_viewer(False)
    assert viewer is not None
    _wait_until(lambda: not viewer.thread.is_alive(), what="the render thread's end")
    assert "GL viewer disabled (ModuleNotFoundError" in capsys.readouterr().out
    grid = np.stack(np.meshgrid(*[np.linspace(-1, 1, 24)] * 3, indexing="ij"), -1)
    viewer.set_voxels(np.linalg.norm(grid, axis=-1) - 0.6)
    assert len(viewer.scene()[0]) > 0 and viewer.model_size == 1.4
    viewer.size = 128
    assert _red(viewer.get_image()) > 200
    viewer.stop()


def test_tears_down_launch_destroys_only_the_group_it_started(tmp_path):
    """A decorated call that starts a process group leaves none behind,
    also when it raises; a group that was there before the call stays."""

    def start_group(name):
        store = dist.FileStore(str(tmp_path / name), 1)
        dist.init_process_group("gloo", store=store, rank=0, world_size=1)

    @mesh_lib.tears_down_launch
    def starts(name, fail=False):
        start_group(name)
        mesh_lib.get_mesh()
        if fail:
            raise RuntimeError("failed")
        return dist.is_initialized()

    assert starts("a") and not dist.is_initialized()
    with pytest.raises(RuntimeError):
        starts("b", fail=True)
    assert not dist.is_initialized()
    start_group("c")
    try:
        assert mesh_lib.tears_down_launch(lambda: 1)() == 1 and dist.is_initialized()
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("name", TRAINERS)
def test_every_launched_trainer_tears_its_group_down(name):
    """All ten callers of ``init_from_env`` carry the teardown."""
    import importlib

    module = importlib.import_module(f"shapegan_tpu_torch.train.{name}")
    with open(module.__file__) as f:
        assert "init_from_env(" in f.read()
    assert module.train.__code__ is mesh_lib.tears_down_launch(lambda: None).__code__


def test_torch_distributed_run_launch_leaves_no_group(tmp_path):
    """Two gloo ranks of ``python -m torch.distributed.run`` each run the
    classifier's entry point; after ``train`` returns no process group is
    left on either rank, and rank 0 alone wrote the CSV."""
    script = tmp_path / "rank.py"
    script.write_text(LAUNCH_SCRIPT)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node=2",
         "--master_addr=127.0.0.1", f"--master_port={port}", str(script)],
        capture_output=True, text=True, timeout=300,
        env=_env(WORKDIR=str(tmp_path), OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    for rank in (0, 1):
        assert f"rank {rank} left a process group: False" in proc.stdout, proc.stdout
    assert len((tmp_path / "plots" / "classifier_training.csv").read_text().splitlines()) == 1
