"""Geometry ops of the port; each kernel-backed op also has a plain version."""

from .chamfer import (
    chamfer_l1,
    chamfer_l2,
    nn_bidir_argmin,
    nn_bidir_argmin_plain,
    nn_distance,
    nn_distance_eval,
)
from .pointops import (
    fps,
    fps_plain,
    furthest_point_sample,
    gather_points,
    gather_rows,
    gather_rows_plain,
    index_points,
    knn_plain,
    knn_point,
    knn_with_distance,
)

__all__ = [
    "chamfer_l1", "chamfer_l2", "nn_bidir_argmin", "nn_bidir_argmin_plain",
    "nn_distance", "nn_distance_eval", "fps", "fps_plain",
    "furthest_point_sample", "gather_points", "gather_rows",
    "gather_rows_plain", "index_points", "knn_plain", "knn_point",
    "knn_with_distance",
]
