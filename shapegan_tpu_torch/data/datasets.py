"""Voxel datasets on the host (counterpart of the parts of
:mod:`shapegan_tpu.data.datasets` that ``train.common.resolve_voxel_dataset``
reads): a list of ``.npy`` SDF volumes, clamped and optionally rescaled as
they are read, and an in-memory array."""

from __future__ import annotations

import glob as globlib
import os
from typing import Optional, Sequence

import numpy as np


class VoxelDataset:
    def __init__(self, files: Sequence[str], clamp: Optional[float] = 0.1, rescale_sdf: bool = True):
        self.files = list(files)
        self.clamp = clamp
        self.rescale_sdf = rescale_sdf

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, index: int) -> np.ndarray:
        array = np.load(self.files[index]).astype(np.float32)
        if self.clamp is not None:
            array = np.clip(array, -self.clamp, self.clamp)
            if self.rescale_sdf:
                array = array / self.clamp
        return array

    @staticmethod
    def glob(pattern: str, clamp: float = 0.1, rescale_sdf: bool = True) -> "VoxelDataset":
        files = sorted(globlib.glob(pattern, recursive=True))
        if not files:
            raise FileNotFoundError(f"No files found for glob pattern {pattern}.")
        return VoxelDataset(files, clamp=clamp, rescale_sdf=rescale_sdf)

    @staticmethod
    def from_split(pattern: str, split_file_name: str, clamp: float = 0.1,
                   rescale_sdf: bool = True) -> "VoxelDataset":
        with open(split_file_name) as f:
            ids = [line.strip() for line in f if line.strip()]
        files = [pattern.format(i) for i in ids]
        files = [f for f in files if os.path.exists(f)]
        return VoxelDataset(files, clamp=clamp, rescale_sdf=rescale_sdf)


class ArrayDataset:
    """Map-style dataset over an in-memory array (synthetic data, tests)."""

    def __init__(self, array: np.ndarray):
        self.array = array

    def __len__(self) -> int:
        return len(self.array)

    def __getitem__(self, index: int) -> np.ndarray:
        return self.array[index]
