"""Prepare training data from a directory of mesh files (.obj / .stl)
(counterpart of the root ``prepare_data.py``, the same arguments).

    python -m shapegan_tpu_torch.prepare_data --input meshes/ --output data/custom \\
        [--resolutions 8 16 32 64] [--rotation 90] [--workers N] \\
        [--no-voxels] [--no-points] [--no-cloud] [--cloud-count N] [--combine] [--split]

Runs on the host (the C++ mesh SDF engine, :mod:`shapegan_tpu_torch.data.prepare`).
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


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--input", required=True, help="directory of .obj/.stl meshes")
    parser.add_argument("--output", default="data/prepared")
    parser.add_argument("--resolutions", type=int, nargs="+", default=[8, 16, 32, 64])
    parser.add_argument("--rotation", type=float, default=None)
    parser.add_argument("--workers", type=int, default=None)
    parser.add_argument("--no-voxels", action="store_true")
    parser.add_argument("--no-points", action="store_true")
    parser.add_argument("--no-cloud", action="store_true")
    parser.add_argument("--cloud-count", type=int, default=200000)
    parser.add_argument("--combine", action="store_true", help="build sdf_points/values.npy")
    parser.add_argument("--split", action="store_true", help="write train/test split files")
    args = parser.parse_args(argv)

    paths = sorted(glob.glob(os.path.join(args.input, "**", "*.obj"), recursive=True)
                   + glob.glob(os.path.join(args.input, "**", "*.stl"), recursive=True))
    if not paths:
        raise SystemExit(f"no meshes found under {args.input}")
    config = PrepareConfig(
        output_dir=args.output,
        voxel_resolutions=args.resolutions,
        make_voxels=not args.no_voxels,
        make_points=not args.no_points,
        make_cloud=not args.no_cloud,
        cloud_count=args.cloud_count,
        rotation=args.rotation,
        workers=args.workers,
    )
    process_mesh_files(paths, config)
    if args.split and not args.no_voxels:
        write_split_file(config)
    if args.combine and not args.no_cloud:
        combine_sdf_clouds(config)


if __name__ == "__main__":
    main()
