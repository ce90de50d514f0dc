"""Dataset metadata: class lists and cross-dataset category maps
(reference: src/core/datasets/metadata.py:8-21)."""

BDD_THING_CLASSES = ["car", "bus", "truck", "person", "rider", "bike", "motor"]
BDD_THING_DATASET_ID_TO_CONTIGUOUS_ID = {
    i + 1: i for i in range(len(BDD_THING_CLASSES))
}

KITTI_THING_CLASSES = ["car", "person"]
KITTI_THING_DATASET_ID_TO_CONTIGUOUS_ID = {
    i + 1: i for i in range(len(KITTI_THING_CLASSES))
}

# BDD-contiguous-id -> KITTI-contiguous-id for shared classes; used when a
# BDD-trained model is evaluated on KITTI (reference: metadata.py:17-21).
BDD_TO_KITTI_CONTIGUOUS_ID = {
    BDD_THING_CLASSES.index(c): KITTI_THING_CLASSES.index(c)
    for c in KITTI_THING_CLASSES
}
