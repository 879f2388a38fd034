"""Prepare ShapeNetCore.v2 categories into training artifacts (counterpart
of the root ``prepare_shapenet_dataset.py``, the same arguments).

    python -m shapegan_tpu_torch.prepare_shapenet_dataset \\
        --dataset data/shapenet/ShapeNetCore.v2 --categories chairs \\
        [--output data] [--limit N] [--workers N] [--combine] [--split]

Walks ``<dataset>/<synset>/<id>/models/model_normalized.obj`` and writes
voxels, uniform and surface samples and DeepSDF clouds per shape under
``<output>/<category>/``; ``--combine`` writes the autodecoder's combined
cloud into ``<output>``.
"""

import argparse
import glob
import os
from typing import List, Optional

from shapegan_tpu_torch.data.prepare import (
    PrepareConfig,
    combine_sdf_clouds,
    process_mesh_files,
    write_split_file,
)
from shapegan_tpu_torch.data.shapenet import ShapeNetMetadata

CATEGORY_ALIASES = {"chairs": "chair", "airplanes": "airplane", "sofas": "sofa"}


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", default="data/shapenet/ShapeNetCore.v2")
    parser.add_argument("--categories", nargs="+", default=["chairs"])
    parser.add_argument("--output", default="data")
    parser.add_argument("--limit", type=int, default=None)
    parser.add_argument("--workers", type=int, default=None)
    parser.add_argument("--combine", action="store_true")
    parser.add_argument("--split", action="store_true")
    args = parser.parse_args(argv)

    metadata = ShapeNetMetadata(args.dataset)
    name_to_synset = {cat.name: synset for synset, cat in metadata.categories.items()}
    for category in args.categories:
        synset = name_to_synset.get(CATEGORY_ALIASES.get(category, category))
        if synset is None:
            raise SystemExit(f"unknown category {category}; have {sorted(name_to_synset)}")
        pattern = os.path.join(args.dataset, synset, "*", "models", "model_normalized.obj")
        paths = sorted(glob.glob(pattern))
        if args.limit:
            paths = paths[:args.limit]
        if not paths:
            raise SystemExit(f"no meshes found for {category} under {pattern}")
        print(f"{category}: {len(paths)} meshes")
        config = PrepareConfig(output_dir=os.path.join(args.output, category), id_mode="shapenet")
        process_mesh_files(paths, config, workers=args.workers)
        if args.split:
            write_split_file(config)
        if args.combine:
            combine_sdf_clouds(config, out_dir=args.output)


if __name__ == "__main__":
    main()
