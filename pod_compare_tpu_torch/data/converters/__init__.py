"""Raw BDD100k, KITTI and Lyft labels to the COCO json that
``data/datasets.py`` registers; each module runs as ``python -m``. The
port's own copies of ``pod_compare_tpu/data/converters``."""
