"""ShapeNet taxonomy metadata (counterpart of :mod:`shapegan_tpu.data.shapenet`).

Parses ``taxonomy.json`` from the dataset directory, falling back to the
copy bundled with the JAX package (``shapegan_tpu/examples/shapenet_taxonomy.json``,
read as a data file), keeps the root categories with at least
:data:`MIN_SAMPLES` instances, maps directory names to labels, and gives
each category a display colour.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List

from shapegan_tpu_torch.checkpoints import EXAMPLES_PATH

MIN_SAMPLES = 2000
BUNDLED_TAXONOMY = os.path.join(EXAMPLES_PATH, "shapenet_taxonomy.json")

# Stable display colors per label index (matplotlib tab20-like).
_COLORS = [
    (0.12, 0.47, 0.71), (1.00, 0.50, 0.05), (0.17, 0.63, 0.17),
    (0.84, 0.15, 0.16), (0.58, 0.40, 0.74), (0.55, 0.34, 0.29),
    (0.89, 0.47, 0.76), (0.50, 0.50, 0.50), (0.74, 0.74, 0.13),
    (0.09, 0.75, 0.81), (0.68, 0.78, 0.91), (1.00, 0.73, 0.47),
    (0.60, 0.87, 0.54), (1.00, 0.60, 0.59), (0.77, 0.69, 0.84),
]


@dataclass
class Category:
    synset_id: str
    name: str
    num_instances: int
    label: int = -1

    @property
    def color(self):
        return _COLORS[self.label % len(_COLORS)]


@dataclass
class ShapeNetMetadata:
    directory: str = "data/shapenet/ShapeNetCore.v2"
    categories: Dict[str, Category] = field(default_factory=dict)

    def __post_init__(self):
        taxonomy_file = os.path.join(self.directory, "taxonomy.json")
        if not os.path.exists(taxonomy_file):
            taxonomy_file = BUNDLED_TAXONOMY
        with open(taxonomy_file) as f:
            taxonomy = json.load(f)

        children = set()
        for entry in taxonomy:
            children.update(entry.get("children", []))
        label = 0
        for entry in taxonomy:
            if entry["synsetId"] in children:
                continue  # not a root category
            if entry.get("numInstances", 0) < MIN_SAMPLES:
                continue
            name = entry["name"].split(",")[0]
            category = Category(entry["synsetId"], name, entry.get("numInstances", 0), label)
            self.categories[entry["synsetId"]] = category
            label += 1

    @property
    def label_count(self) -> int:
        return len(self.categories)

    def get_category(self, synset_id: str) -> Category:
        return self.categories[synset_id]

    def label_for_directory(self, directory_name: str) -> int:
        category = self.categories.get(directory_name)
        return category.label if category is not None else -1

    def get_color(self, label: int):
        return _COLORS[label % len(_COLORS)]

    def labels(self) -> List[str]:
        ordered = sorted(self.categories.values(), key=lambda c: c.label)
        return [c.name for c in ordered]
