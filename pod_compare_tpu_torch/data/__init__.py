"""Datasets, the synthetic dataset and the train and test loaders."""

from pod_compare_tpu_torch.data import metadata
from pod_compare_tpu_torch.data.datasets import (
    DatasetInfo,
    get_dataset,
    list_datasets,
    register_coco_instances,
    setup_all_datasets,
)
from pod_compare_tpu_torch.data.loader import (
    DevicePrefetcher,
    TestLoader,
    TrainLoader,
    load_image_bgr,
    resize_shortest_edge,
    static_canvas,
)

__all__ = [
    "metadata",
    "DatasetInfo",
    "DevicePrefetcher",
    "get_dataset",
    "list_datasets",
    "register_coco_instances",
    "setup_all_datasets",
    "TestLoader",
    "TrainLoader",
    "load_image_bgr",
    "resize_shortest_edge",
    "static_canvas",
]
