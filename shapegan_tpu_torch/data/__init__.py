"""Datasets and host data of the port: synthetic shapes and point clouds,
voxel datasets, triangle meshes."""
