"""The colour maps the figure factory draws with, as matplotlib defines and
applies them (the card's machine has no matplotlib).

The anchor colours are data: ColorBrewer's ``RdBu`` (11 colours) and
``Set1`` (9), matplotlib's ``tab10`` cycle (C0-C9) and ``gray`` (black to
white). ``RdBu`` and ``gray`` are segmented maps, sampled into a table of
256 entries by linear interpolation between the anchors; ``Set1`` and
``tab10`` are listed maps with one entry per colour. A value is mapped as
``Colormap.__call__`` maps it: ``Normalize(vmin, vmax)`` to [0, 1], then
``int(x * N)`` with 1.0 kept in the last bin and values outside [0, 1]
clipped to the ends.
"""

from __future__ import annotations

import numpy as np

RDBU = (
    (0.403921568627451, 0.0, 0.12156862745098039),
    (0.6980392156862745, 0.09411764705882353, 0.16862745098039217),
    (0.8392156862745098, 0.3764705882352941, 0.30196078431372547),
    (0.9568627450980393, 0.6470588235294118, 0.5098039215686274),
    (0.9921568627450981, 0.8588235294117647, 0.7803921568627451),
    (0.9686274509803922, 0.9686274509803922, 0.9686274509803922),
    (0.8196078431372549, 0.8980392156862745, 0.9411764705882353),
    (0.5725490196078431, 0.7725490196078432, 0.8705882352941177),
    (0.2627450980392157, 0.5764705882352941, 0.7647058823529411),
    (0.12941176470588237, 0.4, 0.6745098039215687),
    (0.0196078431372549, 0.18823529411764706, 0.3803921568627451),
)
SET1 = (
    (0.8941176470588236, 0.10196078431372549, 0.10980392156862745),
    (0.21568627450980393, 0.49411764705882355, 0.7215686274509804),
    (0.30196078431372547, 0.6862745098039216, 0.2901960784313726),
    (0.596078431372549, 0.3058823529411765, 0.6392156862745098),
    (1.0, 0.4980392156862745, 0.0),
    (1.0, 1.0, 0.2),
    (0.6509803921568628, 0.33725490196078434, 0.1568627450980392),
    (0.9686274509803922, 0.5058823529411764, 0.7490196078431373),
    (0.6, 0.6, 0.6),
)
TAB10 = (
    (0.12156862745098039, 0.4666666666666667, 0.7058823529411765),
    (1.0, 0.4980392156862745, 0.054901960784313725),
    (0.17254901960784313, 0.6274509803921569, 0.17254901960784313),
    (0.8392156862745098, 0.15294117647058825, 0.1568627450980392),
    (0.5803921568627451, 0.403921568627451, 0.7411764705882353),
    (0.5490196078431373, 0.33725490196078434, 0.29411764705882354),
    (0.8901960784313725, 0.4666666666666667, 0.7607843137254902),
    (0.4980392156862745, 0.4980392156862745, 0.4980392156862745),
    (0.7372549019607844, 0.7411764705882353, 0.13333333333333333),
    (0.09019607843137255, 0.7450980392156863, 0.8117647058823529),
)
GRAY = ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0))
SEGMENTS = 256  # matplotlib's table size for a segmented map

# Named colours the recipes use (matplotlib's CSS values).
NAMED = {"grey": (128 / 255,) * 3, "green": (0.0, 128 / 255, 0.0)}


def _segmented(anchors) -> np.ndarray:
    """[256, 3] table: the anchors evenly spaced on [0, 1], linear between."""
    anchors = np.asarray(anchors, np.float64)
    at = np.linspace(0.0, 1.0, len(anchors))
    x = np.linspace(0.0, 1.0, SEGMENTS)
    return np.stack([np.interp(x, at, anchors[:, c]) for c in range(3)], axis=1)


TABLES = {"RdBu": _segmented(RDBU), "gray": _segmented(GRAY),
          "Set1": np.asarray(SET1), "tab10": np.asarray(TAB10)}


def lookup(x, name: str) -> np.ndarray:
    """RGB in [0, 1] [..., 3] of values ``x`` already normalised to [0, 1]."""
    table = TABLES[name]
    n = len(table)
    xa = np.asarray(x, np.float64) * n
    xa = np.where(xa == n, n - 1, xa)
    index = np.clip(np.floor(xa), 0, n - 1).astype(np.int64)
    return table[index]


def normalize(values, vmin=None, vmax=None) -> np.ndarray:
    """matplotlib's ``Normalize``: ``vmin`` and ``vmax`` default to the
    values' range; equal limits map everything to 0."""
    values = np.asarray(values, np.float64)
    vmin = float(values.min()) if vmin is None else float(vmin)
    vmax = float(values.max()) if vmax is None else float(vmax)
    if vmax == vmin:
        return np.zeros_like(values)
    return (values - vmin) / (vmax - vmin)


def to_rgb(values, name: str, vmin=None, vmax=None) -> np.ndarray:
    """``ScalarMappable(Normalize(vmin, vmax), name).to_rgba(values)``
    without its alpha: RGB in [0, 1] [..., 3]."""
    return lookup(normalize(values, vmin, vmax), name)


def cycle(index: int) -> tuple:
    """The property cycle's colour ``C<index>`` (tab10)."""
    return TAB10[index % len(TAB10)]


def colour(spec) -> tuple:
    """An RGB tuple in [0, 1] from a name (``"grey"``, ``"C3"``,
    ``"tab:blue"``), a ``#rrggbb`` string or a tuple."""
    if isinstance(spec, str):
        if spec in NAMED:
            return NAMED[spec]
        if spec.startswith("#") and len(spec) == 7:
            return tuple(int(spec[i:i + 2], 16) / 255.0 for i in (1, 3, 5))
        if spec.startswith("C") and spec[1:].isdigit():
            return cycle(int(spec[1:]))
        if spec == "tab:blue":
            return TAB10[0]
        raise ValueError(f"unknown colour {spec!r}")
    return tuple(float(v) for v in spec[:3])
