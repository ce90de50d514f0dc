"""Cross-dataset category mapping helpers.

The port's copy of ``pod_compare_tpu/evaluation/category_mapping.py``.

Replicates the reference's two mapping directions
(reference: apply_net.py:53-79 and
evaluation_utils.get_thing_dataset_id_to_contiguous_id_dict:370-397):
  * model-contiguous index → test-dataset category id (for dumping COCO
    json; unmapped classes are dropped)
  * test-dataset category id → model-contiguous index (for evaluating gt
    against model-space probability vectors)

The supported cross pair is BDD-trained → KITTI/Lyft test, via the shared
class names (reference: metadata.py:17-21).
"""

from typing import Dict

from pod_compare_tpu_torch.data import metadata
from pod_compare_tpu_torch.data.datasets import get_dataset


def model_to_dataset_id_map(train_dataset: str, test_dataset: str) -> Dict[int, int]:
    """Model contiguous index -> test dataset category id
    (reference: apply_net.py:53-79)."""
    train_map = get_dataset(train_dataset).thing_dataset_id_to_contiguous_id
    test_map = get_dataset(test_dataset).thing_dataset_id_to_contiguous_id
    inv_test = {v: k for k, v in test_map.items()}  # contiguous -> dataset id
    if train_map == test_map:
        return inv_test
    if "kitti" in test_dataset and "bdd" in train_dataset:
        # bdd contiguous -> kitti contiguous -> kitti dataset id
        return {
            bdd_c: inv_test[kitti_c]
            for bdd_c, kitti_c in metadata.BDD_TO_KITTI_CONTIGUOUS_ID.items()
        }
    raise ValueError(
        f"Cannot map categories between {train_dataset} and {test_dataset}."
    )


def dataset_id_to_model_contiguous_map(
    train_dataset: str, test_dataset: str
) -> Dict[int, int]:
    """Test dataset category id -> model contiguous index
    (reference: evaluation_utils.py:370-397)."""
    train_map = get_dataset(train_dataset).thing_dataset_id_to_contiguous_id
    test_map = get_dataset(test_dataset).thing_dataset_id_to_contiguous_id
    if train_map == test_map:
        return dict(test_map)
    if "kitti" in test_dataset and "bdd" in train_dataset:
        kitti_to_bdd = {
            v: k for k, v in metadata.BDD_TO_KITTI_CONTIGUOUS_ID.items()
        }
        return {ds_id: kitti_to_bdd[c] for ds_id, c in test_map.items()}
    raise ValueError(
        f"Cannot map categories between {train_dataset} and {test_dataset}."
    )
