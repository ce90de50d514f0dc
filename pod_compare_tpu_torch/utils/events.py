"""Scalar metric storage/writers.

The port's own copy of ``pod_compare_tpu/utils/events.py`` (it needs no
framework).

A replacement for detectron2's EventStorage/TensorBoard writers (the
trainer logs ``num_pos_anchors`` among its scalars). Metrics are buffered
in memory, printed periodically, appended as JSON lines to
``metrics.jsonl`` for offline analysis, and written as TensorBoard event
files (first-party writer, ``utils/tb_events.py``), so a stock
``tensorboard --logdir OUTPUT_DIR`` monitors a run.
"""

import json
import os
import time
from collections import defaultdict, deque
from typing import Dict, Optional


class EventStorage:
    """Buffered scalar storage with windowed medians (20-iter window)."""

    def __init__(self, output_dir: Optional[str] = None, window: int = 20):
        self._history = defaultdict(lambda: deque(maxlen=window))
        self._latest: Dict[str, float] = {}
        self.iter = 0
        self._file = None
        self._tb = None
        if output_dir is not None:
            os.makedirs(output_dir, exist_ok=True)
            self._file = open(
                os.path.join(output_dir, "metrics.jsonl"), "a", buffering=1
            )
            from pod_compare_tpu_torch.utils.tb_events import TBEventWriter

            self._tb = TBEventWriter(output_dir)

    def put_scalar(self, name: str, value) -> None:
        value = float(value)
        self._history[name].append(value)
        self._latest[name] = value

    def put_scalars(self, **kwargs) -> None:
        for k, v in kwargs.items():
            self.put_scalar(k, v)

    def median(self, name: str) -> float:
        hist = sorted(self._history[name])
        return hist[len(hist) // 2] if hist else float("nan")

    def latest(self) -> Dict[str, float]:
        return dict(self._latest)

    def write(self) -> None:
        if self._file is not None:
            rec = {"iteration": self.iter, "time": time.time(), **self._latest}
            self._file.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            self._tb.add_scalars(self.iter, self._latest)

    def step(self) -> None:
        self.iter += 1

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None


_CURRENT: Optional[EventStorage] = None


def get_event_storage() -> EventStorage:
    global _CURRENT
    if _CURRENT is None:
        _CURRENT = EventStorage()
    return _CURRENT


def set_event_storage(storage: EventStorage) -> None:
    global _CURRENT
    _CURRENT = storage
