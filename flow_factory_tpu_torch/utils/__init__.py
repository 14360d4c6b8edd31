from .base import derive_seed, make_generator, resolve_device
from .trajectory import TrajectoryIndexMaps, build_store_maps, compute_trajectory_indices

__all__ = ["derive_seed", "make_generator", "resolve_device",
           "TrajectoryIndexMaps", "build_store_maps", "compute_trajectory_indices"]
