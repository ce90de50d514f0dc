"""A batch source made from a seed, for driving the trainer without a dataset.

It has the interface the trainer asks of a loader: a ``canvas`` (H, W) and
``iter_from(start)`` yielding dicts of the four ``TRAIN_BATCH_KEYS`` numpy
arrays, where batch i is a function of (seed, i) alone, so that a resumed
run sees the batches an uninterrupted run would. Canvases are uint8 noise
drawn once; each batch takes them in another order and draws its own ground
truth: 1 to 30 boxes per image (log-uniform sides of 16 to 400 pixels,
uniform classes), padded to ``max_gt_boxes``.
"""

from typing import Dict, Iterator, Tuple

import numpy as np


class RandomBatches:
    def __init__(
        self,
        canvas: Tuple[int, int],
        batch_size: int,
        num_classes: int,
        max_gt_boxes: int = 100,
        seed: int = 0,
    ):
        self.canvas = tuple(int(s) for s in canvas)
        self.batch_size = batch_size
        self.num_classes = num_classes
        self.max_gt_boxes = max_gt_boxes
        self.seed = seed
        rng = np.random.default_rng([seed, 0])
        self._pool = rng.integers(0, 256, (batch_size, *self.canvas, 3), dtype=np.uint8)

    def batch(self, index: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng([self.seed, 1, index])
        b, g = self.batch_size, self.max_gt_boxes
        h, w = self.canvas
        boxes = np.zeros((b, g, 4), np.float32)
        classes = np.zeros((b, g), np.int64)
        valid = np.zeros((b, g), bool)
        for i in range(b):
            n = min(int(rng.integers(1, 31)), g)
            bw = np.minimum(np.exp(rng.uniform(np.log(16), np.log(400), n)), w - 1)
            bh = np.minimum(np.exp(rng.uniform(np.log(16), np.log(400), n)), h - 1)
            x0 = rng.uniform(0, w - bw)
            y0 = rng.uniform(0, h - bh)
            boxes[i, :n] = np.stack([x0, y0, x0 + bw, y0 + bh], axis=1)
            classes[i, :n] = rng.integers(0, self.num_classes, n)
            valid[i, :n] = True
        order = (index + np.arange(b)) % b
        return {"images": self._pool[order], "gt_boxes": boxes, "gt_classes": classes,
                "gt_valid": valid}

    def iter_from(self, start: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        index = start
        while True:
            yield self.batch(index)
            index += 1
