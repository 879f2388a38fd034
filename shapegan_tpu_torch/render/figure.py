"""The figure rasterizer: what the figure factory's recipes draw with, in
place of matplotlib (the card's machine has none).

A recipe builds a :class:`Figure` of panels as it would with matplotlib:
:meth:`Figure.subplots` (matplotlib's default subplot parameters, or the
grid's own) and :meth:`Figure.add_subplot_3d`, and on each :class:`Axes`
the calls of the same names (``plot``, ``hist``, ``bar``, ``imshow``,
``scatter``, ``set_title``, ``set_xlabel``, ``set_ylabel``, ``set_yticks``,
``set_ylim``, ``axis("off")``, ``legend``) plus :meth:`Axes.add_thumbnail`
for ``AnnotationBbox(OffsetImage(image, zoom), xy, frameon=True)``. Each
call only records plain data (lists of dicts of numpy arrays, numbers and
strings: the figure's *spec*), computed by matplotlib's rules: the colour
cycle, ``np.histogram`` for ``hist`` with matplotlib's bar and step
geometry, the colour maps of :mod:`~shapegan_tpu_torch.render.colormaps`.
:meth:`Figure.savefig` draws the spec into a uint8 RGB image of ``figsize
x dpi`` pixels on white and writes it as a PNG.

The layout is the rasterizer's own: data limits with matplotlib's 5 %
margins (bars and steps stick to 0), ticks at the values matplotlib's
``AutoLocator`` picks (:func:`tick_values`), labels formatted as its
``ScalarFormatter`` formats them, text in the bitmap font of
:mod:`~shapegan_tpu_torch.render.font` at ``round(dpi / 72)`` times its
size, ``bbox_inches="tight"`` as a crop to the drawn content plus 0.1 inch.
The background is white where a matplotlib figure may be transparent.

A 3-D panel (:class:`Axes3D`) draws scatter points from matplotlib's
default view (elevation 30, azimuth -60, its perspective and box aspect 4:4:3),
sorted by depth, with no panes, grid or ticks.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np

from shapegan_tpu_torch.render import colormaps, font
from shapegan_tpu_torch.render.png import write_png

MARGIN = 0.05                       # matplotlib's axes.xmargin / ymargin
SUBPLOT = dict(left=0.125, right=0.9, bottom=0.11, top=0.88, wspace=0.2, hspace=0.2)
FONT_PT = 10.0                      # matplotlib's font.size
TICK_PT, TICK_PAD_PT, LABEL_PAD_PT, TITLE_PAD_PT = 3.5, 3.5, 4.0, 6.0
STEPS = np.array([0.1, 0.2, 0.25, 0.5, 1.0, 2.0, 2.5, 5.0, 10.0, 20.0])  # AutoLocator's, extended
TIGHT_PAD_INCH = 0.1


# ------------------------------------------------------------------ ticks


def _scale_range(vmin: float, vmax: float, n: int):
    dv = abs(vmax - vmin)
    meanv = (vmax + vmin) / 2
    offset = 0.0 if abs(meanv) / dv < 100 else math.copysign(10 ** (math.log10(abs(meanv)) // 1), meanv)
    return 10 ** (math.log10(dv / n) // 1), offset


def _edge(step: float, offset: float):
    tol = 1e-10
    if offset > 0:
        tol = min(0.4999, max(1e-10, 10 ** (math.log10(abs(offset) / step) - 12)))

    def le(x):
        d, m = divmod(x, step)
        return d + 1 if abs(m / step - 1) < tol else d

    def ge(x):
        d, m = divmod(x, step)
        return d if abs(m / step) < tol else d + 1

    return le, ge


def tick_values(vmin: float, vmax: float, nbins: int) -> np.ndarray:
    """The ticks matplotlib's ``AutoLocator`` (``MaxNLocator`` with steps 1,
    2, 2.5, 5, 10 and at least two ticks) picks for the view ``[vmin,
    vmax]`` and ``nbins`` (its ``'auto'`` rule: the axis length over three
    (x) or two (y) label heights, clipped to 1-9), those outside the view
    included."""
    if vmax < vmin:
        vmin, vmax = vmax, vmin
    if vmax - vmin <= 1e-14 * max(abs(vmin), abs(vmax), 1e-300):  # nonsingular
        if vmin == 0:
            vmin, vmax = -1e-13, 1e-13
        else:
            vmin, vmax = vmin - abs(vmin) * 1e-13, vmax + abs(vmax) * 1e-13
    scale, offset = _scale_range(vmin, vmax, nbins)
    lo, hi = vmin - offset, vmax - offset
    steps = STEPS * scale
    raw = (hi - lo) / nbins
    large = np.nonzero(steps >= raw)[0]
    istep = large[0] if len(large) else len(steps) - 1
    for step in steps[:istep + 1][::-1]:
        best = (lo // step) * step
        le, ge = _edge(step, offset)
        ticks = np.arange(le(lo - best), ge(hi - best) + 1) * step + best
        if ((ticks <= hi) & (ticks >= lo)).sum() >= 2:
            break
    return ticks + offset


def tick_labels(locs: np.ndarray):
    """(labels, exponent) of ticks as matplotlib's ``ScalarFormatter``
    writes them: an exponent ``1eN`` above the axis when the largest value
    is below 1e-5 or at least 1e6, then ``%1.<k>f`` with the fewest
    decimals that keep each value to a thousandth of the ticks' range."""
    locs = np.asarray(locs, np.float64)
    biggest = float(np.abs(locs).max()) if len(locs) else 0.0
    oom = 0
    if biggest > 0:
        oom = int(math.floor(math.log10(biggest)))
        oom = oom if oom <= -5 or oom >= 6 else 0
    scaled = locs / 10.0 ** oom
    span = float(np.ptp(scaled)) if len(scaled) > 1 else 0.0
    span = span or (float(np.abs(scaled).max()) if len(scaled) else 0.0) or 1.0
    span_oom = int(math.floor(math.log10(span)))
    decimals = max(0, 3 - span_oom)
    thresh = 1e-3 * 10 ** span_oom
    while decimals >= 0 and np.abs(scaled - np.round(scaled, decimals)).max() < thresh:
        decimals -= 1
    decimals += 1
    labels = [f"{v:1.{decimals}f}" for v in scaled]
    return [text.lstrip("-") if float(text) == 0 else text for text in labels], oom


# ------------------------------------------------------------ drawing ops


def _blend(canvas, region, coverage, colour, alpha=1.0):
    """Blend ``colour`` into ``canvas[region]`` by ``coverage * alpha``."""
    a = (np.clip(coverage, 0.0, 1.0) * alpha)[..., None]
    canvas[region] = canvas[region] * (1.0 - a) + np.asarray(colour, np.float64) * a


def _clip_box(box, shape):
    x0, y0, x1, y1 = box
    return (max(int(math.floor(x0)), 0), max(int(math.floor(y0)), 0),
            min(int(math.ceil(x1)), shape[1]), min(int(math.ceil(y1)), shape[0]))


def polyline_coverage(points, width: float, box, shape) -> tuple:
    """(region, coverage) of a polyline of pixel points [N, 2] (x, y) of
    ``width`` pixels, clipped to ``box`` (x0, y0, x1, y1): each pixel's
    coverage is one inside half the width of a segment, falling to 0 over
    one pixel."""
    x0, y0, x1, y1 = _clip_box(box, shape)
    cover = np.zeros((max(y1 - y0, 0), max(x1 - x0, 0)))
    half = width / 2.0
    pts = np.asarray(points, np.float64)
    if len(pts) == 1:
        pts = np.concatenate([pts, pts])
    for (ax_, ay), (bx, by) in zip(pts[:-1], pts[1:]):
        if not np.isfinite([ax_, ay, bx, by]).all():
            continue
        sx0, sx1 = int(math.floor(min(ax_, bx) - half - 1)), int(math.ceil(max(ax_, bx) + half + 1))
        sy0, sy1 = int(math.floor(min(ay, by) - half - 1)), int(math.ceil(max(ay, by) + half + 1))
        sx0, sy0, sx1, sy1 = max(sx0, x0), max(sy0, y0), min(sx1, x1), min(sy1, y1)
        if sx1 <= sx0 or sy1 <= sy0:
            continue
        ys, xs = np.mgrid[sy0:sy1, sx0:sx1] + 0.5
        dx, dy = bx - ax_, by - ay
        length2 = dx * dx + dy * dy
        t = np.zeros_like(xs) if length2 == 0 else np.clip(((xs - ax_) * dx + (ys - ay) * dy) / length2, 0, 1)
        dist = np.hypot(xs - (ax_ + t * dx), ys - (ay + t * dy))
        sub = cover[sy0 - y0:sy1 - y0, sx0 - x0:sx1 - x0]
        np.maximum(sub, np.clip(half + 0.5 - dist, 0.0, 1.0), out=sub)
    return (slice(y0, y1), slice(x0, x1)), cover


def draw_polyline(canvas, points, colour, width, box, alpha=1.0):
    region, cover = polyline_coverage(points, width, box, canvas.shape)
    if cover.size:
        _blend(canvas, region, cover, colour, alpha)


def draw_disc(canvas, x, y, radius, colour, alpha=1.0):
    x0, y0, x1, y1 = _clip_box((x - radius - 1, y - radius - 1, x + radius + 1, y + radius + 1),
                               canvas.shape)
    if x1 <= x0 or y1 <= y0:
        return
    ys, xs = np.mgrid[y0:y1, x0:x1] + 0.5
    cover = np.clip(radius + 0.5 - np.hypot(xs - x, ys - y), 0.0, 1.0)
    _blend(canvas, (slice(y0, y1), slice(x0, x1)), cover, colour, alpha)


def fill_rect(canvas, x0, y0, x1, y1, colour, alpha=1.0):
    """Fill the pixels whose centres lie in [x0, x1) x [y0, y1)."""
    c0, r0 = max(int(round(min(x0, x1))), 0), max(int(round(min(y0, y1))), 0)
    c1, r1 = min(int(round(max(x0, x1))), canvas.shape[1]), min(int(round(max(y0, y1))), canvas.shape[0])
    if c1 > c0 and r1 > r0:
        _blend(canvas, (slice(r0, r1), slice(c0, c1)), np.ones((r1 - r0, c1 - c0)), colour, alpha)


def draw_text(canvas, text, x, y, scale, colour=(0.0, 0.0, 0.0), ha="left", va="top",
              rotate=False):
    """Draw ``text`` anchored at pixel (x, y) by ``ha`` (left, center,
    right) and ``va`` (top, center, bottom); ``rotate`` turns it a quarter
    left (a y label). Returns its box (x0, y0, x1, y1)."""
    mask = font.text_mask(text, scale)
    if rotate:
        mask = np.rot90(mask)
    h, w = mask.shape
    left = x - {"left": 0, "center": w / 2, "right": w}[ha]
    top = y - {"top": 0, "center": h / 2, "bottom": h}[va]
    left, top = int(round(left)), int(round(top))
    box = (left, top, left + w, top + h)
    c0, r0, c1, r1 = _clip_box(box, canvas.shape)
    if c1 > c0 and r1 > r0:
        sub = mask[r0 - top:r1 - top, c0 - left:c1 - left]
        _blend(canvas, (slice(r0, r1), slice(c0, c1)), sub.astype(np.float64), colour)
    return box


def image_rgb(array, cmap=None, vmin=None, vmax=None) -> np.ndarray:
    """An ``imshow`` array as RGB in [0, 1]: a 2-D array through its colour
    map (``vmin`` / ``vmax`` default to its range); uint8 RGB(A) over 255."""
    array = np.asarray(array)
    if array.ndim == 2:
        return colormaps.to_rgb(array, cmap, vmin, vmax)
    rgb = array[..., :3]
    return rgb / 255.0 if rgb.dtype == np.uint8 else np.clip(rgb.astype(np.float64), 0, 1)


def fit_image(rgb: np.ndarray, width: int, height: int) -> np.ndarray:
    """``rgb`` [h, w, 3] resampled to [height, width] by the nearest source
    pixel of each target pixel's centre."""
    h, w = rgb.shape[:2]
    rows = np.minimum(((np.arange(height) + 0.5) * h / height).astype(np.int64), h - 1)
    cols = np.minimum(((np.arange(width) + 0.5) * w / width).astype(np.int64), w - 1)
    return rgb[rows][:, cols]


def fitted_box(box, aspect: float) -> tuple:
    """The largest box of ``aspect`` (height over width) centred in ``box``
    (x0, y0, x1, y1), as matplotlib's ``aspect="equal"`` shrinks an axes."""
    x0, y0, x1, y1 = box
    w, h = x1 - x0, y1 - y0
    if h / w > aspect:
        nh = w * aspect
        return (x0, y0 + (h - nh) / 2, x1, y0 + (h + nh) / 2)
    nw = h / aspect
    return (x0 + (w - nw) / 2, y0, x0 + (w + nw) / 2, y1)


def _union(boxes):
    boxes = [b for b in boxes if b is not None]
    if not boxes:
        return None
    b = np.array(boxes, np.float64)
    return (b[:, 0].min(), b[:, 1].min(), b[:, 2].max(), b[:, 3].max())


# ------------------------------------------------------------------- axes


class Axes:
    """One panel's spec. ``box`` is (left, bottom, width, height) in
    figure fractions; the artists are lists of dicts in drawing order."""

    def __init__(self, box):
        self.box = tuple(box)
        self.title = self.xlabel = self.ylabel = ""
        self.lines: List[dict] = []
        self.bars: List[dict] = []
        self.steps: List[dict] = []
        self.images: List[dict] = []
        self.scatters: List[dict] = []
        self.thumbnails: List[dict] = []
        self.legend_entries: List[dict] = []  # labelled artists, in the order they were made
        self.legend_loc: Optional[str] = None
        self.axis_on = True
        self.yticks: Optional[list] = None    # None: AutoLocator's
        self.ylim: Optional[tuple] = None
        self._lines_cycle = 0                 # plot and hist draw from one cycle,
        self._patches_cycle = 0               # bar and scatter from another (matplotlib's)
        self.view = None                      # set by drawing: (xmin, xmax, ymin, ymax)
        self.frame = None                     # and (x0, y0, x1, y1) in pixels

    def _next_line_colour(self):
        colour = colormaps.cycle(self._lines_cycle)
        self._lines_cycle += 1
        return colour

    def _label(self, label, kind, colour, **extra):
        if label and not str(label).startswith("_"):
            self.legend_entries.append({"label": str(label), "kind": kind, "color": colour, **extra})

    # -------------------------------------------------- matplotlib's calls

    def plot(self, x, y=None, fmt=None, color=None, linestyle=None, linewidth=1.5, label=None):
        """``ax.plot(y)``, ``ax.plot(x, y)`` or ``ax.plot(x, y, "x")``."""
        if y is None or isinstance(y, str):
            x, y, fmt = np.arange(len(np.asarray(x))), x, y if isinstance(y, str) else fmt
        marker = "x" if fmt == "x" else None
        linestyle = linestyle or ("None" if marker else "-")
        colour = colormaps.colour(color) if color is not None else self._next_line_colour()
        self.lines.append({"x": np.asarray(x, np.float64), "y": np.asarray(y, np.float64),
                           "color": colour, "linestyle": linestyle, "linewidth": float(linewidth),
                           "marker": marker, "label": label})
        self._label(label, "line", colour, linestyle=linestyle, marker=marker,
                    linewidth=float(linewidth))

    def hist(self, x, bins=10, range=None, density=False, histtype="bar", color=None, alpha=None,
             label=None):
        """``ax.hist``: one dataset, or a 2-D array's columns as datasets
        (one colour each); returns the heights [datasets, bins]."""
        x = np.asarray(x)  # its dtype sets the bin edges' (np.histogram's rule)
        datasets = [x.reshape(-1)] if x.ndim == 1 else [x[:, i] for i in np.arange(x.shape[1])]
        if isinstance(bins, int):
            edges = np.histogram_bin_edges(np.concatenate(datasets), bins, range)
        else:
            edges = np.asarray(bins, np.float64)
        if color is None:
            colours = [self._next_line_colour() for _ in datasets]
        elif isinstance(color, (list, tuple)) and not isinstance(color[0], (int, float)):
            colours = [colormaps.colour(c) for c in color]
        else:
            colours = [colormaps.colour(color)] * len(datasets)
        tops = np.stack([np.histogram(d, edges, density=density)[0].astype(np.float64)
                         for d in datasets])
        edges = edges.astype(np.float64)
        n = len(edges)
        for top, colour in zip(tops, colours):
            if histtype == "step":
                # matplotlib's outline: up and along each bin, open at the end
                xs = np.zeros(2 * n)
                ys = np.zeros(2 * n)
                xs[0::2], xs[1::2] = edges, edges
                ys[1:-1:2], ys[2:-1:2] = top, top
                self.steps.append({"x": xs, "y": ys, "color": colour})
            else:
                widths = np.diff(edges)
                if len(datasets) > 1:  # side by side, 0.8 of the bin
                    raise NotImplementedError("several datasets as bars")
                self.bars.append({"x": edges[:-1], "width": widths, "height": top,
                                  "bottom": np.zeros_like(top), "color": colour,
                                  "alpha": 1.0 if alpha is None else float(alpha)})
        if label:
            self._label(label, "patch", colours[0], alpha=1.0 if alpha is None else float(alpha))
        return tops

    def bar(self, x, height, width=0.8, color=None):
        """``ax.bar`` centred on ``x``."""
        x = np.asarray(x, np.float64)
        if color is None:
            colour = colormaps.cycle(self._patches_cycle)
            self._patches_cycle += 1
        else:
            colour = colormaps.colour(color)
        height = np.asarray(height, np.float64)
        self.bars.append({"x": x - width / 2.0, "width": np.full(len(x), float(width)),
                          "height": height, "bottom": np.zeros_like(height), "color": colour,
                          "alpha": 1.0})

    def imshow(self, array, cmap=None, vmin=None, vmax=None, origin="upper"):
        """An RGB image, or a 2-D array through the colour map ``cmap``
        (``vmin`` / ``vmax`` default to its range)."""
        array = np.asarray(array)
        if array.ndim == 2:
            if cmap not in colormaps.TABLES:
                raise ValueError(f"a 2-D image needs one of the colour maps {sorted(colormaps.TABLES)}")
            vmin = float(array.min()) if vmin is None else float(vmin)
            vmax = float(array.max()) if vmax is None else float(vmax)
        self.images.append({"array": array, "cmap": cmap, "vmin": vmin, "vmax": vmax,
                            "origin": origin})

    def scatter(self, x, y, c=None, s=None, cmap=None):
        """``ax.scatter``: ``c`` a colour, RGB rows, or labels through the
        colour map ``cmap`` (normalised over their range); ``s`` the marker
        area in points^2 (matplotlib's default 36)."""
        offsets = np.stack([np.asarray(x, np.float64), np.asarray(y, np.float64)], axis=1)
        if c is None:
            colour = colormaps.cycle(self._patches_cycle)
            self._patches_cycle += 1
            colours = np.tile(colour, (len(offsets), 1))
        elif isinstance(c, str) or (np.ndim(c) == 1 and len(c) in (3, 4) and len(offsets) != len(c)):
            colours = np.tile(colormaps.colour(c), (len(offsets), 1))
        elif np.ndim(c) == 2:
            colours = np.asarray(c, np.float64)[:, :3]
        else:
            colours = colormaps.to_rgb(c, cmap)
        self.scatters.append({"offsets": offsets, "colors": colours,
                              "size": 36.0 if s is None else float(s)})

    def add_thumbnail(self, image, xy, zoom=0.5):
        """``AnnotationBbox(OffsetImage(image, zoom=zoom), xy, frameon=True)``."""
        self.thumbnails.append({"image": np.asarray(image), "xy": tuple(map(float, xy)),
                                "zoom": float(zoom)})

    def set_title(self, text):
        self.title = str(text)

    def set_xlabel(self, text):
        self.xlabel = str(text)

    def set_ylabel(self, text):
        self.ylabel = str(text)

    def set_yticks(self, ticks):
        self.yticks = list(ticks)

    def set_ylim(self, limits):
        self.ylim = tuple(map(float, limits))

    def axis(self, state):
        if state != "off":
            raise ValueError(f"axis({state!r}) is not supported")
        self.axis_on = False

    def legend(self, loc="best"):
        self.legend_loc = loc

    # ------------------------------------------------------------ limits

    def data_limits(self):
        """(xmin, xmax, ymin, ymax) of the view: the artists' range with
        5 % margins, bars and steps held at 0 where they start there; an
        image's extent as it stands."""
        if self.images:
            h, w = self.images[0]["array"].shape[:2]
            return (-0.5, w - 0.5, -0.5, h - 0.5) if self.images[0]["origin"] == "lower" \
                else (-0.5, w - 0.5, h - 0.5, -0.5)
        xs, ys, sticky = [], [], []
        for line in self.lines:
            xs.append(line["x"]), ys.append(line["y"])
        for bar in self.bars:
            xs += [bar["x"], bar["x"] + bar["width"]]
            ys += [bar["bottom"], bar["bottom"] + bar["height"]]
            sticky.append(0.0)
        for step in self.steps:
            xs.append(step["x"]), ys.append(step["y"])
            sticky.append(0.0)
        for sc in self.scatters:
            xs.append(sc["offsets"][:, 0]), ys.append(sc["offsets"][:, 1])
        for th in self.thumbnails:
            xs.append(np.array([th["xy"][0]])), ys.append(np.array([th["xy"][1]]))
        if not xs:
            return (0.0, 1.0, 0.0, 1.0)
        x = np.concatenate([np.ravel(v) for v in xs])
        y = np.concatenate([np.ravel(v) for v in ys])
        x, y = x[np.isfinite(x)], y[np.isfinite(y)]
        xmin, xmax = self._margins(x.min(), x.max(), [])
        ymin, ymax = self._margins(y.min(), y.max(), sticky)
        if self.ylim is not None:
            ymin, ymax = self.ylim
        return (xmin, xmax, ymin, ymax)

    @staticmethod
    def _margins(lo, hi, sticky):
        lo, hi = float(lo), float(hi)
        if hi == lo:
            lo, hi = lo - 0.05 * (abs(lo) or 1.0), hi + 0.05 * (abs(hi) or 1.0)
            return lo, hi
        span = hi - lo
        new_lo, new_hi = lo - MARGIN * span, hi + MARGIN * span
        for s in sticky:  # a margin never crosses a sticky edge inside the data
            if new_lo < s <= lo:
                new_lo = s
            if hi <= s < new_hi:
                new_hi = s
        return new_lo, new_hi

    # ------------------------------------------------------------- drawing

    def draw(self, canvas, frame, dpi) -> tuple:
        """Draw the panel into ``canvas`` (float RGB) in the pixel box
        ``frame`` (x0, y0, x1, y1); returns the box of what was drawn."""
        px = dpi / 72.0
        scale = max(1, int(round(dpi / 72.0)))
        if self.images:
            h, w = self.images[0]["array"].shape[:2]
            frame = fitted_box(frame, h / w)
        self.frame = frame
        xmin, xmax, ymin, ymax = self.view = self.data_limits()
        x0, y0, x1, y1 = frame

        def to_px(x, y):
            return (x0 + (np.asarray(x, np.float64) - xmin) / (xmax - xmin) * (x1 - x0),
                    y1 - (np.asarray(y, np.float64) - ymin) / (ymax - ymin) * (y1 - y0))

        drawn = [frame] if self.axis_on else []
        for image in self.images:
            rgb = image_rgb(image["array"], image["cmap"], image["vmin"], image["vmax"])
            if image["origin"] == "lower":
                rgb = rgb[::-1]
            c0, r0 = int(round(x0)), int(round(y0))
            c1, r1 = int(round(x1)), int(round(y1))
            canvas[r0:r1, c0:c1] = fit_image(rgb, c1 - c0, r1 - r0)
            drawn.append((c0, r0, c1, r1))
        for bar in self.bars:
            left, top = to_px(bar["x"], bar["bottom"] + bar["height"])
            right, bottom = to_px(bar["x"] + bar["width"], bar["bottom"])
            for l, t, r, b in zip(left, top, right, bottom):
                fill_rect(canvas, max(l, x0), max(min(t, b), y0), min(r, x1), min(max(t, b), y1),
                          bar["color"], bar["alpha"])
        for step in self.steps:
            draw_polyline(canvas, np.stack(to_px(step["x"], step["y"]), 1), step["color"],
                          1.5 * px, frame)
        for line in self.lines:
            pts = np.stack(to_px(line["x"], line["y"]), 1)
            if line["linestyle"] == "-":
                draw_polyline(canvas, pts, line["color"], line["linewidth"] * px, frame)
            if line["marker"] == "x":
                half = 3.0 * px
                for cx, cy in pts:
                    if x0 <= cx <= x1 and y0 <= cy <= y1:
                        for sx in (-1, 1):
                            draw_polyline(canvas, [(cx - half, cy - sx * half), (cx + half, cy + sx * half)],
                                          line["color"], px, (cx - 2 * half, cy - 2 * half,
                                                              cx + 2 * half, cy + 2 * half))
        for sc in self.scatters:
            radius = math.sqrt(sc["size"]) / 2.0 * px
            cx, cy = to_px(sc["offsets"][:, 0], sc["offsets"][:, 1])
            for x, y, colour in zip(cx, cy, sc["colors"]):
                draw_disc(canvas, x, y, radius, colour)
        for th in self.thumbnails:
            drawn.append(self._draw_thumbnail(canvas, th, to_px(*th["xy"]), px))
        if self.axis_on:
            drawn += self._draw_axes(canvas, frame, px, scale)
        if self.title:
            drawn.append(draw_text(canvas, self.title, (x0 + x1) / 2, y0 - TITLE_PAD_PT * px,
                                   scale, ha="center", va="bottom"))
        if self.legend_loc and self.legend_entries:
            drawn.append(self._draw_legend(canvas, frame, px, scale))
        return _union(drawn)

    @staticmethod
    def _draw_thumbnail(canvas, th, centre, px):
        image = th["image"]
        h, w = image.shape[:2]
        th_w, th_h = max(1, int(round(w * th["zoom"] * px))), max(1, int(round(h * th["zoom"] * px)))
        rgb = fit_image(image_rgb(image, "gray"), th_w, th_h)
        cx, cy = centre
        left, top = int(round(cx - th_w / 2)), int(round(cy - th_h / 2))
        pad = int(round(0.4 * FONT_PT * px))
        box = (left - pad, top - pad, left + th_w + pad, top + th_h + pad)
        fill_rect(canvas, *box, (1.0, 1.0, 1.0))
        outline = [(box[0], box[1]), (box[2], box[1]), (box[2], box[3]), (box[0], box[3]),
                   (box[0], box[1])]
        draw_polyline(canvas, outline, (0.0, 0.0, 0.0), max(1.0, px), _grow(box, 2))
        c0, r0, c1, r1 = _clip_box((left, top, left + th_w, top + th_h), canvas.shape)
        if c1 > c0 and r1 > r0:
            canvas[r0:r1, c0:c1] = rgb[r0 - top:r1 - top, c0 - left:c1 - left]
        return box

    def _draw_axes(self, canvas, frame, px, scale):
        x0, y0, x1, y1 = frame
        xmin, xmax, ymin, ymax = self.view
        black = (0.0, 0.0, 0.0)
        width = max(1.0, 0.8 * px)
        outline = [(x0, y0), (x1, y0), (x1, y1), (x0, y1), (x0, y0)]
        draw_polyline(canvas, outline, black, width, _grow(frame, width + 1))
        tick, pad = TICK_PT * px, TICK_PAD_PT * px
        boxes = []
        # x ticks below
        xt = tick_values(xmin, xmax, int(np.clip((x1 - x0) / px // (FONT_PT * 3), 1, 9)))
        xt = xt[(xt >= min(xmin, xmax) - 1e-9 * abs(xmax - xmin)) & (xt <= max(xmin, xmax) + 1e-9 * abs(xmax - xmin))]
        labels, oom = tick_labels(xt)
        bottom = y1
        for value, text in zip(xt, labels):
            x = x0 + (value - xmin) / (xmax - xmin) * (x1 - x0)
            draw_polyline(canvas, [(x, y1), (x, y1 + tick)], black, width, (x - 2, y1 - 1, x + 2, y1 + tick + 1))
            box = draw_text(canvas, text, x, y1 + tick + pad, scale, ha="center", va="top")
            boxes.append(box)
            bottom = max(bottom, box[3])
        if oom:
            boxes.append(draw_text(canvas, f"1e{oom}", x1, bottom, scale, ha="right", va="top"))
        # y ticks left
        if self.yticks is None:
            yt = tick_values(ymin, ymax, int(np.clip((y1 - y0) / px // (FONT_PT * 2), 1, 9)))
            lo, hi = min(ymin, ymax), max(ymin, ymax)
            yt = yt[(yt >= lo - 1e-9 * (hi - lo)) & (yt <= hi + 1e-9 * (hi - lo))]
        else:
            yt = np.asarray(self.yticks, np.float64)
        labels, oom = tick_labels(yt) if len(yt) else ([], 0)
        left = x0
        for value, text in zip(yt, labels):
            y = y1 - (value - ymin) / (ymax - ymin) * (y1 - y0)
            draw_polyline(canvas, [(x0 - tick, y), (x0, y)], black, width, (x0 - tick - 1, y - 2, x0 + 1, y + 2))
            box = draw_text(canvas, text, x0 - tick - pad, y, scale, ha="right", va="center")
            boxes.append(box)
            left = min(left, box[0])
        if oom:
            boxes.append(draw_text(canvas, f"1e{oom}", x0, y0 - 2, scale, ha="left", va="bottom"))
        if self.xlabel:
            boxes.append(draw_text(canvas, self.xlabel, (x0 + x1) / 2, bottom + LABEL_PAD_PT * px,
                                   scale, ha="center", va="top"))
        if self.ylabel:
            boxes.append(draw_text(canvas, self.ylabel, left - LABEL_PAD_PT * px, (y0 + y1) / 2,
                                   scale, ha="right", va="center", rotate=True))
        return boxes

    def _draw_legend(self, canvas, frame, px, scale):
        x0, y0, x1, y1 = frame
        fs = FONT_PT * px
        row_h = max(font.HEIGHT * scale, 0.7 * fs) * 1.3
        handle = 2.0 * fs
        text_w = max(font.text_width(e["label"], scale) for e in self.legend_entries)
        width = 0.4 * fs + handle + 0.8 * fs + text_w + 0.4 * fs
        height = 0.4 * fs * 2 + row_h * len(self.legend_entries)
        right = x1 - 0.5 * fs
        top = y0 + 0.5 * fs if self.legend_loc != "center right" else (y0 + y1) / 2 - height / 2
        box = (right - width, top, right, top + height)
        fill_rect(canvas, *box, (1.0, 1.0, 1.0), 0.8)
        outline = [(box[0], box[1]), (box[2], box[1]), (box[2], box[3]), (box[0], box[3]), (box[0], box[1])]
        draw_polyline(canvas, outline, (0.8, 0.8, 0.8), max(1.0, px), _grow(box, 2))
        for i, entry in enumerate(self.legend_entries):
            cy = top + 0.4 * fs + row_h * (i + 0.5)
            hx0 = box[0] + 0.4 * fs
            if entry["kind"] == "line":
                if entry.get("linestyle") == "-":
                    draw_polyline(canvas, [(hx0, cy), (hx0 + handle, cy)], entry["color"],
                                  entry["linewidth"] * px, _grow(box, 0))
            else:
                fill_rect(canvas, hx0, cy - 0.35 * fs, hx0 + handle, cy + 0.35 * fs, entry["color"],
                          entry.get("alpha", 1.0))
            draw_text(canvas, entry["label"], hx0 + handle + 0.8 * fs, cy, scale, va="center")
        return box


def _grow(box, by):
    return (box[0] - by, box[1] - by, box[2] + by, box[3] + by)


class Axes3D:
    """A 3-D scatter panel seen from matplotlib's default view."""

    ELEV, AZIM, DIST, FOCAL = 30.0, -60.0, 10.0, 1.0
    BOX_ASPECT = np.array([4.0, 4.0, 3.0]) * 1.8294640721620434 * 25 / 24 / math.sqrt(41.0)

    def __init__(self, box):
        self.box = tuple(box)
        self.title = ""
        self.scatters: List[dict] = []
        self._patches_cycle = 0

    def scatter(self, xs, ys, zs, c=None, s=20.0):
        points = np.stack([np.asarray(v, np.float64) for v in (xs, ys, zs)], axis=1)
        if c is None:
            colours = np.tile(colormaps.cycle(self._patches_cycle), (len(points), 1))
            self._patches_cycle += 1
        else:
            colours = np.broadcast_to(np.asarray(c, np.float64)[..., :3], (len(points), 3)).copy()
        self.scatters.append({"points": points, "colors": colours, "size": float(s)})

    def set_title(self, text):
        self.title = str(text)

    def limits(self) -> np.ndarray:
        """[3, 2] data limits: the points' range with 5 % margins, then a
        48th of that on each side (matplotlib's 3-D autoscale)."""
        points = np.concatenate([sc["points"] for sc in self.scatters])
        lo, hi = points.min(0), points.max(0)
        span = np.where(hi > lo, hi - lo, 1.0)
        lo, hi = lo - MARGIN * span, hi + MARGIN * span
        pad = (hi - lo) / 48.0
        return np.stack([lo - pad, hi + pad], axis=1)

    def projection(self) -> np.ndarray:
        """The 4 x 4 matrix of matplotlib's ``Axes3D.get_proj``: the limits
        to the box aspect, the eye at distance 10 on (elev, azim), a
        perspective of focal length 1."""
        lim = self.limits()
        d = (lim[:, 1] - lim[:, 0]) / self.BOX_ASPECT
        world = np.eye(4)
        world[:3, :3] = np.diag(1.0 / d)
        world[:3, 3] = -lim[:, 0] / d
        centre = 0.5 * self.BOX_ASPECT
        elev, azim = np.deg2rad(self.ELEV), np.deg2rad(self.AZIM)
        ps = np.array([np.cos(elev) * np.cos(azim), np.cos(elev) * np.sin(azim), np.sin(elev)])
        eye = centre + self.DIST * ps
        w = (eye - centre) / np.linalg.norm(eye - centre)
        u = np.cross([0.0, 0.0, 1.0], w)
        u /= np.linalg.norm(u)
        v = np.cross(w, u)
        eye_focal = centre + self.DIST * ps * self.FOCAL
        rot, shift = np.eye(4), np.eye(4)
        rot[:3, :3] = [u, v, w]
        shift[:3, 3] = -eye_focal
        zf, zb = -self.DIST, self.DIST
        persp = np.array([[self.FOCAL, 0, 0, 0], [0, self.FOCAL, 0, 0],
                          [0, 0, (zf + zb) / (zf - zb), -2 * zf * zb / (zf - zb)], [0, 0, -1, 0]])
        return persp @ rot @ shift @ world

    def project(self, points) -> np.ndarray:
        """Points [N, 3] → (screen x, screen y up, depth) [N, 3]."""
        homo = np.concatenate([np.asarray(points, np.float64), np.ones((len(points), 1))], 1)
        out = homo @ self.projection().T
        return out[:, :3] / out[:, 3:4]

    def draw(self, canvas, frame, dpi) -> tuple:
        self.frame = frame
        px = dpi / 72.0
        scale = max(1, int(round(dpi / 72.0)))
        side = min(frame[2] - frame[0], frame[3] - frame[1])
        cx, cy = (frame[0] + frame[2]) / 2, (frame[1] + frame[3]) / 2
        lim = self.limits()
        corners = np.array([[lim[0, i], lim[1, j], lim[2, k]] for i in (0, 1) for j in (0, 1)
                            for k in (0, 1)])
        ref = self.project(corners)
        span = max(np.ptp(ref[:, 0]), np.ptp(ref[:, 1]))
        mid = (ref[:, :2].max(0) + ref[:, :2].min(0)) / 2
        fit = side / span
        drawn = [(cx - side / 2, cy - side / 2, cx + side / 2, cy + side / 2)]
        everything = [(sc["points"], sc["colors"], sc["size"]) for sc in self.scatters]
        points = np.concatenate([p for p, _, _ in everything])
        colours = np.concatenate([c for _, c, _ in everything])
        sizes = np.concatenate([np.full(len(p), s) for p, _, s in everything])
        proj = self.project(points)
        order = np.argsort(-proj[:, 2], kind="stable")  # far (larger depth) first
        for i in order:
            x = cx + (proj[i, 0] - mid[0]) * fit
            y = cy - (proj[i, 1] - mid[1]) * fit
            draw_disc(canvas, x, y, max(0.5, math.sqrt(sizes[i]) / 2.0 * px), colours[i])
        if self.title:
            drawn.append(draw_text(canvas, self.title, cx, cy - side / 2 - TITLE_PAD_PT * px, scale,
                                   ha="center", va="bottom"))
        return _union(drawn)


# ----------------------------------------------------------------- figure


def grid_boxes(rows, cols, **params) -> dict:
    """{(row, col): (left, bottom, width, height)} of a grid of panels by
    matplotlib's ``GridSpec`` rule: ``left``, ``right``, ``bottom``,
    ``top`` in figure fractions (matplotlib's defaults), ``wspace`` /
    ``hspace`` as fractions of a panel's size."""
    p = {**SUBPLOT, **params}
    cell_w = (p["right"] - p["left"]) / (cols + p["wspace"] * (cols - 1))
    cell_h = (p["top"] - p["bottom"]) / (rows + p["hspace"] * (rows - 1))
    return {(r, c): (p["left"] + c * cell_w * (1 + p["wspace"]),
                     p["top"] - (r + 1) * cell_h - r * cell_h * p["hspace"], cell_w, cell_h)
            for r in range(rows) for c in range(cols)}


class Figure:
    """A figure of ``figsize`` inches at ``dpi``: ``figsize * dpi`` pixels."""

    def __init__(self, figsize=(6.4, 4.8), dpi=100):
        self.figsize = tuple(map(float, figsize))
        self.dpi = float(dpi)
        self.width = int(round(self.figsize[0] * self.dpi))
        self.height = int(round(self.figsize[1] * self.dpi))
        self.axes: list = []

    def subplots(self, rows=1, cols=1, **params) -> np.ndarray:
        """A grid of panels [rows, cols] (:func:`grid_boxes`)."""
        grid = np.empty((rows, cols), object)
        for (r, c), box in grid_boxes(rows, cols, **params).items():
            grid[r, c] = Axes(box)
            self.axes.append(grid[r, c])
        return grid

    def add_subplot_3d(self, rows, cols, index) -> Axes3D:
        """``fig.add_subplot(rows, cols, index, projection="3d")``."""
        ax = Axes3D(grid_boxes(rows, cols)[(index - 1) // cols, (index - 1) % cols])
        self.axes.append(ax)
        return ax

    def pixel_box(self, box, border=0) -> tuple:
        """A panel's (left, bottom, width, height) as pixels (x0, y0, x1,
        y1) of a canvas with ``border`` pixels around the figure."""
        left, bottom, width, height = box
        return (border + left * self.width, border + (1 - bottom - height) * self.height,
                border + (left + width) * self.width, border + (1 - bottom) * self.height)

    def render(self, tight=True):
        """The figure as uint8 RGB on white: [H, W, 3], or with ``tight``
        cropped to the drawn content plus 0.1 inch (content beyond the
        figure's edge included, as ``bbox_inches="tight"`` grows the
        figure). Also returns the crop's (x0, y0) relative to the figure."""
        border = int(round(self.dpi)) if tight else 0  # room for text past the edge
        canvas = np.ones((self.height + 2 * border, self.width + 2 * border, 3))
        drawn = [ax.draw(canvas, self.pixel_box(ax.box, border), self.dpi) for ax in self.axes]
        for ax in self.axes:  # panels' frames relative to the figure
            ax.frame = tuple(v - border for v in ax.frame)
        image = np.uint8(np.round(np.clip(canvas, 0, 1) * 255))
        content = _union(drawn)
        if not tight or content is None:
            return image[border:border + self.height, border:border + self.width], (0, 0)
        x0, y0, x1, y1 = _clip_box(_grow(content, TIGHT_PAD_INCH * self.dpi), image.shape)
        return image[y0:y1, x0:x1], (x0 - border, y0 - border)

    def savefig(self, filename, tight=True):
        image, self.offset = self.render(tight)
        write_png(filename, image)
        return image
