"""Geometry ops of the port; each kernel-backed op also has a plain version."""

from .chamfer import (
    chamfer_l1,
    chamfer_l1_pm,
    chamfer_l2,
    chamfer_l2_split,
    mxu_eval_chamfer_active,
    nn_argmin_bidir_mxu,
    nn_argmin_bidir_mxu_plain,
    nn_bidir_argmin,
    nn_bidir_argmin_plain,
    nn_distance,
    nn_distance_eval,
    nn_one_direction,
    nn_one_direction_plain,
)
from .emd import auction_top2, auction_top2_plain, emd_auction, emd_distance_metric
from .gather_sum import (
    weighted_gather_sum,
    weighted_gather_sum_dfeats,
    weighted_gather_sum_dfeats_plain,
    weighted_gather_sum_dweights,
    weighted_gather_sum_dweights_plain,
    weighted_gather_sum_plain,
)
from .normals import estimate_pointcloud_normals
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
    scatter_add_rows,
    scatter_add_rows_plain,
    three_interpolate,
    three_nn,
    three_nn_interpolate,
    three_nn_interpolate_grouped,
    three_nn_interpolate_grouped_plain,
    three_nn_interpolate_plain,
    three_weights,
)
from .sampling import (
    jitter_points,
    random_dropping,
    random_sample,
    random_scale,
    separate_point_cloud,
    train_random_crop,
)

__all__ = [
    "chamfer_l1", "chamfer_l1_pm", "chamfer_l2", "chamfer_l2_split",
    "nn_bidir_argmin", "nn_bidir_argmin_plain", "nn_distance",
    "nn_distance_eval", "nn_one_direction", "nn_one_direction_plain", "fps",
    "fps_plain", "furthest_point_sample", "gather_points", "gather_rows",
    "gather_rows_plain", "index_points", "jitter_points", "knn_plain",
    "knn_point", "knn_with_distance", "scatter_add_rows",
    "scatter_add_rows_plain", "estimate_pointcloud_normals", "weighted_gather_sum",
    "weighted_gather_sum_plain", "weighted_gather_sum_dfeats", "weighted_gather_sum_dfeats_plain",
    "weighted_gather_sum_dweights", "weighted_gather_sum_dweights_plain", "auction_top2",
    "auction_top2_plain", "emd_auction", "emd_distance_metric", "mxu_eval_chamfer_active",
    "nn_argmin_bidir_mxu", "nn_argmin_bidir_mxu_plain", "three_interpolate", "three_nn",
    "three_nn_interpolate", "three_nn_interpolate_grouped", "three_nn_interpolate_grouped_plain",
    "three_nn_interpolate_plain", "three_weights", "random_dropping", "random_sample", "random_scale",
    "separate_point_cloud", "train_random_crop",
]
