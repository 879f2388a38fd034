"""A scatter panel of a 2-D embedding, drawn into a uint8 image with numpy
(the part of ``demo_latent_space.py``'s matplotlib figure the port draws;
the card's machine has no matplotlib).

Points are small discs in matplotlib's ``tab10`` colours (labels mapped as
``scatter(c=labels, cmap="tab10")`` maps them) at alpha 0.6 on white, the
axes scaled to the data's range with a margin, and a cursor drawn as a
black cross. There is no text (no title, ticks or labels): the machine has
no fonts.
"""

from __future__ import annotations

import numpy as np

from shapegan_tpu_torch.render import colormaps

POINT_ALPHA = 0.6
MARGIN = 0.05


def tab10_colours(labels) -> np.ndarray:
    """RGB in [0, 1] [N, 3] of each label as matplotlib colours ``c=labels``
    with ``cmap="tab10"``: the labels normalised over their range (all 0
    when they are equal), then one of ten bins."""
    return colormaps.to_rgb(labels, "tab10")


class ScatterPanel:
    """The embedding's points drawn once into a [size, size, 3] panel;
    :meth:`with_cursor` returns a copy with the cursor."""

    def __init__(self, points, labels, size: int):
        points = np.asarray(points, np.float64)
        self.size = int(size)
        lo, hi = points.min(0), points.max(0)
        span = np.maximum(hi - lo, 1e-12)
        self._lo = lo - MARGIN * span
        self._span = span * (1 + 2 * MARGIN)
        image = np.ones((self.size, self.size, 3))
        radius = max(1.0, self.size / 250.0)
        for (row, col), colour in zip(self.pixels(points), tab10_colours(labels)):
            self._blend_disc(image, row, col, radius, colour)
        self.image = np.uint8(np.round(image * 255.0))

    def pixels(self, points) -> np.ndarray:
        """(row, column) [N, 2] of points in the panel: x to the right, y up."""
        unit = (np.asarray(points, np.float64).reshape(-1, 2) - self._lo) / self._span
        return np.stack([(1.0 - unit[:, 1]) * (self.size - 1), unit[:, 0] * (self.size - 1)], 1)

    @staticmethod
    def _blend_disc(image, row, col, radius, colour) -> None:
        r0, r1 = int(np.floor(row - radius)), int(np.ceil(row + radius)) + 1
        c0, c1 = int(np.floor(col - radius)), int(np.ceil(col + radius)) + 1
        r0, c0 = max(r0, 0), max(c0, 0)
        rows, cols = np.mgrid[r0:r1, c0:c1]
        inside = (rows - row) ** 2 + (cols - col) ** 2 <= radius ** 2
        patch = image[r0:r1, c0:c1]
        inside = inside[:patch.shape[0], :patch.shape[1]]
        patch[inside] = patch[inside] * (1 - POINT_ALPHA) + colour * POINT_ALPHA

    def with_cursor(self, point) -> np.ndarray:
        """The panel with a black cross at the 2-D ``point``."""
        image = self.image.copy()
        row, col = self.pixels(point)[0]
        half = max(3.0, self.size / 40.0)
        width = max(1.0, self.size / 200.0)
        r0, r1 = max(int(row - half), 0), min(int(row + half) + 1, self.size)
        c0, c1 = max(int(col - half), 0), min(int(col + half) + 1, self.size)
        rows, cols = np.mgrid[r0:r1, c0:c1]
        dr, dc = rows - row, cols - col
        on_cross = np.minimum(np.abs(dr - dc), np.abs(dr + dc)) / np.sqrt(2.0) <= width / 2 + 0.5
        on_cross &= (np.abs(dr) <= half) & (np.abs(dc) <= half)
        image[r0:r1, c0:c1][on_cross] = 0
        return image
