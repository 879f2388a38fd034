"""``python -m shapegan_tpu_torch.demo_data_preparation`` against the root
``demo_data_preparation.py``: the printed voxel slices, the 3-D scatter
panels' points, colours and view, the two figures written."""

import os
import sys

import numpy as np
import pytest
import torch

import test_torch_plot_env as env
from shapegan_tpu_torch import demo_data_preparation
from shapegan_tpu_torch.examples import example_chair_path

# The 3-D panel's screen positions against matplotlib's projection of the
# JAX figure's axes, by the correlation of each screen axis.
SCREEN_CORRELATION = 0.99



def test_demo_needs_cuda_unless_cpu(tmp_path, monkeypatch):
    """On CUDA by default: without a card it raises before any work."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        demo_data_preparation.main([])
    assert not os.listdir(tmp_path)


@pytest.fixture(scope="module")
def data_preparation(tmp_path_factory):
    """Both demos' output in one directory: the JAX demo's figures
    (captured) and printed text, the port's result and printed text. The
    JAX demo reads the port's chair file (its own would be written under
    ``shapegan_tpu/``)."""
    import contextlib
    import io

    import matplotlib.figure

    root = tmp_path_factory.mktemp("data_preparation")
    chair = example_chair_path(device="cpu")
    sys.path.insert(0, env.REPO)
    import demo_data_preparation as jax_demo

    figures = []
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(root)
        mp.setattr(jax_demo, "example_chair_path", lambda: chair)
        mp.setattr(matplotlib.figure.Figure, "savefig", lambda self, *a, **k: figures.append(self))
        mp.setattr("matplotlib.pyplot.close", lambda *a: None)
        theirs = io.StringIO()
        with contextlib.redirect_stdout(theirs):
            jax_demo.main()
        ours = io.StringIO()
        with contextlib.redirect_stdout(ours):
            result = demo_data_preparation.main(["cpu"])
    return {"root": root, "figures": figures, "theirs": theirs.getvalue(), "ours": ours.getvalue(),
            "result": result}


def _slices(text):
    return [block.split("\n\n")[0] for block in text.split("voxels at ")[1:]]


def test_demo_data_preparation_prints_the_jax_slices(data_preparation):
    """The three voxelizations' ASCII slices, character for character; the
    two figures written."""
    ours, theirs = _slices(data_preparation["ours"]), _slices(data_preparation["theirs"])
    assert len(ours) == len(theirs) == 3
    assert ours == theirs
    out = data_preparation["root"] / "screenshots" / "data_preparation"
    from shapegan_tpu_torch.render.png import read_png

    for name, size in (("voxels.png", (400, 1200)), ("points.png", (500, 1000))):
        image = read_png(str(out / name))
        assert image.shape[:2] == size and (image != 255).any()


def test_demo_data_preparation_scatters_match_jax(data_preparation):
    """Each 3-D panel's points and colours equal the JAX figure's
    (``_offsets3d``, face colours), its title too; the screen positions
    correlate with matplotlib's projection under the JAX axes' view."""
    from mpl_toolkits.mplot3d import proj3d

    figures = data_preparation["figures"]
    result = data_preparation["result"]
    assert len(figures) == 2
    for ours, theirs in zip((result["voxels_figure"], result["points_figure"]), figures):
        assert ours.figsize == tuple(theirs.get_size_inches()) and len(ours.axes) == len(theirs.axes)
        # the colours as set (``get_facecolor`` depth-shades and sorts them)
        colours = [want.collections[0]._facecolors[:, :3].copy() for want in theirs.axes]
        theirs.canvas.draw()  # sets the view (and depth-shades the colours)
        for ax, want, want_colours in zip(ours.axes, theirs.axes, colours):
            assert ax.title == want.get_title()
            (scatter,), (collection,) = ax.scatters, want.collections
            xs, ys, zs = (np.asarray(v) for v in collection._offsets3d)
            np.testing.assert_allclose(scatter["points"], np.stack([xs, ys, zs], 1), rtol=1e-6)
            np.testing.assert_allclose(scatter["colors"], np.broadcast_to(want_colours, scatter["colors"].shape),
                                       atol=1e-12)
            screen = ax.project(scatter["points"])
            want_x, want_y, _ = proj3d.proj_transform(xs, ys, zs, want.get_proj())
            assert np.corrcoef(screen[:, 0], want_x)[0, 1] >= SCREEN_CORRELATION
            assert np.corrcoef(screen[:, 1], want_y)[0, 1] >= SCREEN_CORRELATION
