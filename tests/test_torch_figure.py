"""The figure factory's drawing pieces against the libraries the JAX
package draws with: ``render/png.read_png`` against Pillow, the colour
maps, tick locator and 3-D view against matplotlib, and the rasterizer's
pixels on known figures."""

import os

import matplotlib
import numpy as np
import pytest
from PIL import Image

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
from matplotlib.cm import ScalarMappable  # noqa: E402
from matplotlib.colors import Normalize  # noqa: E402

from shapegan_tpu_torch.render import colormaps, font  # noqa: E402
from shapegan_tpu_torch.render.figure import (Figure, fit_image, grid_boxes, tick_labels,  # noqa: E402
                                              tick_values)
from shapegan_tpu_torch.render.png import read_png, write_png  # noqa: E402

# A colour map's RGB against matplotlib's: the same tables, so equal up to
# float rounding; the bound is one level of 255.
COLOUR_ATOL = 1 / 255
# Data ranges of the ticks test: unit, signed, large, tiny, offset, and the
# ranges the recipes draw (a CSV's epochs, hist densities, the codes' +-0.42
# and +-4, the bar column's -3..3, voxel counts up to 32^3).
TICK_RANGES = [(0, 1), (-0.0123, 3.7), (0.5, 1003), (-4.2, 4.2), (0.001, 0.0013),
               (12345, 12399), (-0.462, 0.462), (0, 32768), (1e-6, 3e-6), (-3, 3),
               (-0.2, 4.2), (0.0, 0.79), (-1.1, 1.1), (0.95, 5.05)]


def _pil_image(mode, kind, rng, height=37, width=53):
    channels = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
    if kind == "random":
        array = rng.integers(0, 256, (height, width, channels), dtype=np.uint8)
    else:  # smooth ramps: PIL's filter choice then varies row by row
        yy, xx = np.mgrid[:height, :width]
        array = np.stack([(xx * 3 + yy * (c + 1) * 2 + (xx * yy) % 7) % 256
                          for c in range(channels)], -1).astype(np.uint8)
    return Image.fromarray(array[..., 0] if channels == 1 else array, mode)


def _filters(path):
    """The row filters of an 8-bit PNG file's rows."""
    import struct
    import zlib

    data = open(path, "rb").read()
    pos, idat, header = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", data[pos + 8:pos + 8 + length])
        if tag == b"IDAT":
            idat.append(data[pos + 8:pos + 8 + length])
        pos += 12 + length
    width, height, _, colour = header[:4]
    stride = width * {0: 1, 2: 3, 4: 2, 6: 4}[colour] + 1
    raw = zlib.decompress(b"".join(idat))
    return {raw[r * stride] for r in range(height)}


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA"])
def test_read_png_matches_pil(mode, tmp_path):
    """Files Pillow writes (odd sizes, random and smooth content, so every
    row filter occurs across them) read back equal to
    ``np.asarray(Image.open(path))``."""
    rng = np.random.default_rng(0)
    seen = set()
    for kind in ("random", "smooth"):
        for height, width in ((37, 53), (5, 1), (64, 29)):
            path = str(tmp_path / f"{kind}-{height}.png")
            _pil_image(mode, kind, rng, height, width).save(path)
            seen |= _filters(path)
            got, want = read_png(path), np.asarray(Image.open(path))
            assert got.dtype == np.uint8 and got.shape == want.shape
            np.testing.assert_array_equal(got, want)
    assert seen >= {0, 1, 2, 4}, seen  # Pillow's choice; Average: the test below


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _write_filtered_png(path, array, colour):
    """An 8-bit PNG whose row y is filtered with filter y % 5, by the PNG
    specification's forward filters."""
    import struct
    import zlib

    height, width = array.shape[:2]
    bpp = array.size // (height * width)
    rows = array.reshape(height, -1).astype(np.int64)
    raw = bytearray()
    for y in range(height):
        kind, line = y % 5, rows[y]
        prior = rows[y - 1] if y else np.zeros_like(line)
        out = []
        for i, x in enumerate(line):
            a = int(line[i - bpp]) if i >= bpp else 0
            b, c = int(prior[i]), (int(prior[i - bpp]) if i >= bpp else 0)
            pred = [0, a, b, (a + b) >> 1, _paeth(a, b, c)][kind]
            out.append((int(x) - pred) % 256)
        raw += bytes([kind] + out)

    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8, colour, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(bytes(raw))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels, colour", [(1, 0), (2, 4), (3, 2), (4, 6)])
def test_read_png_undoes_every_filter(channels, colour, tmp_path):
    """Rows filtered None, Sub, Up, Average and Paeth in turn (byte
    arithmetic modulo 256) read back as the pixels written; Pillow reads
    the same file the same way."""
    rng = np.random.default_rng(7)
    array = rng.integers(0, 256, (15, 13, channels), dtype=np.uint8)
    array[5:] = np.clip(array[5:] // 8 + np.arange(13)[None, :, None] * 9, 0, 255)  # smooth rows
    path = str(tmp_path / "f.png")
    _write_filtered_png(path, array, colour)
    assert _filters(path) == {0, 1, 2, 3, 4}
    want = array[..., 0] if channels == 1 else array
    np.testing.assert_array_equal(read_png(path), want)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), want)


def test_read_png_expands_palettes_and_reads_write_png(tmp_path):
    """A palette file (1, 2, 4 and 8-bit indices) reads as Pillow's
    ``convert("RGB")`` of it; ``write_png``'s files read back exactly."""
    rng = np.random.default_rng(1)
    path = str(tmp_path / "p.png")
    for colours in (2, 4, 16, 200):
        image = Image.fromarray(rng.integers(0, 256, (21, 31, 3), dtype=np.uint8))
        image.convert("P", palette=Image.ADAPTIVE, colors=colours).save(path)
        np.testing.assert_array_equal(read_png(path), np.asarray(Image.open(path).convert("RGB")))
    rgb = rng.integers(0, 256, (9, 11, 3), dtype=np.uint8)
    write_png(path, rgb)
    np.testing.assert_array_equal(read_png(path), rgb)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), rgb)


def test_read_png_refuses_16_bit_and_interlaced(tmp_path):
    path = str(tmp_path / "deep.png")
    Image.fromarray(np.arange(64, dtype=np.uint16).reshape(8, 8) * 1000).save(path)
    with pytest.raises(ValueError, match="bit depth 16"):
        read_png(path)
    import struct
    import zlib

    write_png(path, np.zeros((8, 8, 3), np.uint8))  # then its IHDR marked Adam7
    data = bytearray(open(path, "rb").read())
    data[28] = 1  # IHDR's interlace byte
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])))
    open(path, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="interlace 1"):
        read_png(path)


@pytest.mark.parametrize("name", ["RdBu", "gray", "Set1", "tab10"])
def test_colour_maps_match_matplotlib(name):
    """``to_rgb`` against ``ScalarMappable(Normalize(vmin, vmax), cmap)``
    on random data with the ends and values outside; ``c=labels`` mapping
    (normalised over the labels' range) equal to matplotlib's."""
    rng = np.random.default_rng(2)
    x = rng.normal(0, 0.1, 5000)
    x[:5] = [-0.1, 0.1, 0.0, -0.5, 0.5]
    want = ScalarMappable(Normalize(-0.1, 0.1), matplotlib.colormaps[name]).to_rgba(x)[:, :3]
    np.testing.assert_allclose(colormaps.to_rgb(x, name, -0.1, 0.1), want, atol=COLOUR_ATOL)
    labels = rng.integers(0, 7, 60)
    want = ScalarMappable(Normalize(labels.min(), labels.max()),
                          matplotlib.colormaps[name]).to_rgba(labels)[:, :3]
    if name in ("Set1", "tab10"):
        np.testing.assert_array_equal(colormaps.to_rgb(labels, name), want)
    else:
        np.testing.assert_allclose(colormaps.to_rgb(labels, name), want, atol=COLOUR_ATOL)
    for i in range(12):
        assert colormaps.colour(f"C{i}") == matplotlib.colors.to_rgb(f"C{i}")
    for spec in ("grey", "green", "tab:blue", "#1f77b4"):
        np.testing.assert_allclose(colormaps.colour(spec), matplotlib.colors.to_rgb(spec))


def test_tick_values_and_labels_match_autolocator():
    """The ticks and their labels for each range equal those matplotlib's
    ``AutoLocator`` and ``ScalarFormatter`` give an 8 x 5 inch figure's
    axes (its nbins from the axis length)."""
    for lo, hi in TICK_RANGES:
        fig, ax = plt.subplots(figsize=(8, 5))
        ax.set_xlim(lo, hi)
        ax.set_ylim(lo, hi)
        fig.canvas.draw()
        for axis, per in ((ax.xaxis, 3), (ax.yaxis, 2)):
            nbins = int(np.clip(axis.get_tick_space(), 1, 9))
            got = tick_values(lo, hi, nbins)
            np.testing.assert_allclose(got, axis.get_major_locator()(), rtol=1e-12, atol=1e-15)
            shown = [t for t in axis.get_major_ticks() if lo <= t.get_loc() <= hi]
            inside = got[(got >= lo) & (got <= hi)]
            labels, oom = tick_labels(inside)
            want = [t.label1.get_text().replace("−", "-") for t in shown]
            assert labels == want, (lo, hi, labels, want)
            assert oom == axis.get_major_formatter().orderOfMagnitude
        plt.close(fig)


def test_font_renders_every_glyph():
    """Every printable ASCII character has a glyph with ink (the space
    none); a string's width is its length times the advance at any scale;
    math text is drawn as its plain letters."""
    for code in range(32, 127):
        mask = font.text_mask(chr(code), 1)
        assert mask.shape == (font.HEIGHT, font.WIDTH)
        assert mask.any() == (code != 32), chr(code)
    text = "Critic output (0.400)"
    for scale in (1, 2, 3):
        assert font.text_width(text, scale) == len(text) * font.WIDTH * scale
        assert font.text_mask(text, scale).shape == (font.HEIGHT * scale, len(text) * 6 * scale)
    assert font.plain_text(r"$\mathbf{z}^{(i)}$") == "z(i)"
    assert font.plain_text(r"$\mathbf{z}$") == "z"
    assert font.plain_text("N(0, 1.000)") == "N(0, 1.000)"
    np.testing.assert_array_equal(font.text_mask("é"), font.text_mask("?"))


def test_lines_land_on_their_pixels():
    """A horizontal and a vertical line of 1 pt at 144 dpi (2 pixels) lie
    on the rows and columns the panel's data-to-pixel map gives, and
    nowhere else inside the frame."""
    fig = Figure((4, 4), 144)
    ax = fig.subplots()[0, 0]
    ax.plot([0.0, 10.0], [3.0, 3.0], linewidth=1.0, color="C3")
    ax.plot([7.0, 7.0], [0.0, 6.0], linewidth=1.0, color="C2")
    image, (ox, oy) = fig.render(tight=False)
    x0, y0, x1, y1 = ax.frame
    xmin, xmax, ymin, ymax = ax.view
    assert (xmin, xmax) == pytest.approx((-0.5, 10.5)) and (ymin, ymax) == pytest.approx((-0.3, 6.3))
    row = y1 - (3.0 - ymin) / (ymax - ymin) * (y1 - y0)
    col = x0 + (7.0 - xmin) / (xmax - xmin) * (x1 - x0)
    inner = image[int(y0) + 3:int(y1) - 3, int(x0) + 3:int(x1) - 3].astype(int)
    red = np.nonzero((np.abs(inner - np.round(np.array(colormaps.cycle(3)) * 255)).sum(2) < 4))
    green = np.nonzero((np.abs(inner - np.round(np.array(colormaps.cycle(2)) * 255)).sum(2) < 4))
    assert len(red[0]) and len(green[0])
    # pixel centres within half the width (1 pixel) of the line
    assert np.abs(red[0] + int(y0) + 3 + 0.5 - row).max() <= 1.0
    assert np.abs(green[1] + int(x0) + 3 + 0.5 - col).max() <= 1.0
    painted = (inner != 255).any(axis=2)
    near = (np.abs(np.arange(inner.shape[0])[:, None] + int(y0) + 3 + 0.5 - row) <= 1.5) | \
        (np.abs(np.arange(inner.shape[1])[None, :] + int(x0) + 3 + 0.5 - col) <= 1.5)
    assert not (painted & ~near).any()


def test_hist_and_bar_geometry_match_matplotlib():
    """``hist`` (bars with density and a range, a 2-D input's columns as
    step outlines) and ``bar`` record matplotlib's heights, edges and step
    vertices."""
    rng = np.random.default_rng(3)
    data = rng.normal(0, 0.5, (300, 12))
    fig, ax = plt.subplots()
    ours = Figure().subplots()[0, 0]
    ax.hist(data[:, 0], bins=20, range=(-1, 1), density=True)
    ours.hist(data[:, 0], bins=20, range=(-1, 1), density=True)
    bars = ax.patches[:20]
    np.testing.assert_allclose(ours.bars[0]["height"], [p.get_height() for p in bars], atol=1e-12)
    np.testing.assert_allclose(ours.bars[0]["x"], [p.get_x() for p in bars], atol=1e-12)
    np.testing.assert_allclose(ours.bars[0]["width"], [p.get_width() for p in bars], atol=1e-12)
    fig2, ax2 = plt.subplots()
    patches = ax2.hist(data[:, ::4], bins=10, range=(-1, 1), histtype="step", density=True,
                       color=["#1f77b4"] * 3)[2]
    ours.hist(data[:, ::4], bins=10, range=(-1, 1), histtype="step", density=True,
              color=["#1f77b4"] * 3)
    assert len(ours.steps) == len(patches) == 3
    for step, (patch,) in zip(ours.steps, patches):
        xy = patch.get_xy()[:len(step["x"])]
        np.testing.assert_allclose(np.stack([step["x"], step["y"]], 1), xy, atol=1e-12)
    fig3, ax3 = plt.subplots()
    ax3.bar(range(8), data[0, :8])
    ours.bar(range(8), data[0, :8])
    np.testing.assert_allclose(ours.bars[-1]["x"], [p.get_x() for p in ax3.patches], atol=1e-12)
    np.testing.assert_allclose(ours.bars[-1]["height"], [p.get_height() for p in ax3.patches])
    plt.close("all")


def test_imshow_fits_the_panel_and_grid_layout_matches_gridspec():
    """An image panel with ``axis("off")`` is the image fitted into the
    cell with its aspect kept (``fit_image``), ``origin="lower"`` flipped;
    grid cells sit where matplotlib's ``GridSpec`` puts them."""
    rng = np.random.default_rng(4)
    fig = Figure((6, 3), 100)
    axes = fig.subplots(1, 2, left=0, right=1, top=1, bottom=0, wspace=0.2, hspace=0.2)
    image = rng.integers(0, 256, (30, 20, 3), dtype=np.uint8)
    axes[0, 0].imshow(image)
    axes[0, 0].axis("off")
    axes[0, 1].imshow(image, origin="lower")
    axes[0, 1].axis("off")
    canvas, _ = fig.render(tight=False)
    for ax, want in ((axes[0, 0], image), (axes[0, 1], image[::-1])):
        c0, r0, c1, r1 = (int(round(v)) for v in ax.frame)
        assert abs((r1 - r0) / (c1 - c0) - 1.5) < 0.02
        np.testing.assert_array_equal(canvas[r0:r1, c0:c1], fit_image(want, c1 - c0, r1 - r0))
    mpl_fig, mpl_axes = plt.subplots(2, 3, figsize=(8, 5))
    for (r, c), box in grid_boxes(2, 3).items():
        np.testing.assert_allclose(box, mpl_axes[r, c].get_position().bounds, atol=1e-12)
    plt.close("all")


def test_3d_view_matches_matplotlib():
    """The 3-D panel's limits and projection matrix equal matplotlib's
    ``Axes3D`` after a scatter of the same points (default view)."""
    rng = np.random.default_rng(5)
    points = rng.uniform(-1, 1, (200, 3)) * [1.0, 2.0, 0.5]
    fig = plt.figure(figsize=(12, 4))
    ax = fig.add_subplot(1, 3, 1, projection="3d")
    ax.scatter(points[:, 0], points[:, 1], points[:, 2], s=2)
    fig.canvas.draw()
    ours = Figure((12, 4), 100).add_subplot_3d(1, 3, 1)
    ours.scatter(points[:, 0], points[:, 1], points[:, 2], s=2)
    np.testing.assert_allclose(ours.limits(), [ax.get_xlim3d(), ax.get_ylim3d(), ax.get_zlim3d()],
                               rtol=1e-12)
    np.testing.assert_allclose(ours.projection(), ax.get_proj(), rtol=1e-10, atol=1e-12)
    plt.close(fig)


def test_figure_text_and_tight_crop(tmp_path):
    """Titles, labels, tick labels and a legend are drawn (ink outside the
    frame); the tight crop keeps all of it with 0.1 inch of white around."""
    fig = Figure((6.4, 4.8), 120)
    ax = fig.subplots()[0, 0]
    ax.plot(np.arange(5), np.arange(5) ** 2, label="squares")
    ax.set_title("Title")
    ax.set_xlabel("Epoch")
    ax.set_ylabel(r"$\mathbf{z}$")
    ax.legend()
    path = str(tmp_path / "f.png")
    image = fig.savefig(path)
    np.testing.assert_array_equal(read_png(path), image)
    ink = (image != 255).any(axis=2)
    rows, cols = np.nonzero(ink)
    pad = int(0.1 * 120)
    assert rows.min() >= pad - 1 and cols.min() >= pad - 1
    assert image.shape[0] - 1 - rows.max() >= pad - 1 and image.shape[1] - 1 - cols.max() >= pad - 1
    x0, y0, x1, y1 = ax.frame
    ox, oy = fig.offset
    above = ink[:int(y0 - oy) - 2]
    assert above.any()  # the title
    assert ink[:, :int(x0 - ox) - 2].any()  # tick labels and the y label
    assert os.path.getsize(path) > 0
