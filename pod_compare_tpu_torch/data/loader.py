"""Input pipeline for inference: decode → resize → pad-to-static-canvas → batch.

The inference half of ``pod_compare_tpu/data/loader.py``, with the same
geometry and the same batches: every image is resized with detectron2's
shortest-edge rule and padded onto one canvas computed from the dataset's
image sizes, and the last batch is padded by repeating its last image and
flagged in ``batch_valid``. Images are read and resized by
``data/image_io.py`` (no OpenCV). A thread pool decodes, a background thread
keeps batches ready, and ``DevicePrefetcher`` copies the next batch to the
card from pinned memory on a side CUDA stream while the current one runs.

Not ported yet (ROADMAP §1): ``TrainLoader`` with flips and multi-scale
training, and the ``process`` worker backend.
"""

import concurrent.futures
import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from pod_compare_tpu_torch.data.datasets import DatasetInfo
from pod_compare_tpu_torch.data.image_io import imread_bgr, resize_bilinear


def resize_shortest_edge(h: int, w: int, min_size: int, max_size: int) -> Tuple[int, int]:
    """detectron2 ResizeShortestEdge geometry: scale shortest side to
    `min_size`, capping the longest at `max_size`."""
    scale = min_size / min(h, w)
    if max(h, w) * scale > max_size:
        scale = max_size / max(h, w)
    return int(h * scale + 0.5), int(w * scale + 0.5)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def static_canvas(
    sizes: List[Tuple[int, int]], min_size: int, max_size: int, divisibility: int
) -> Tuple[int, int]:
    """Static padded (H, W) covering every resized image in the dataset."""
    hs, ws = zip(*[resize_shortest_edge(h, w, min_size, max_size) for h, w in set(sizes)])
    return round_up(max(hs), divisibility), round_up(max(ws), divisibility)


@dataclass
class LoaderConfig:
    min_size: int
    max_size: int
    divisibility: int = 32
    max_gt_boxes: int = 100
    flip: bool = False
    image_format: str = "BGR"
    # detectron2's "choice" sampling over MIN_SIZE_TRAIN (training only)
    min_size_choices: Optional[Tuple[int, ...]] = None


def _prepare_record(
    record: dict, lc: LoaderConfig, canvas: Tuple[int, int], rng: np.random.RandomState
) -> Dict[str, np.ndarray]:
    # uint8 BGR (the reference's INPUT.FORMAT) through resize, pad and
    # batch; the model normalises on the device
    img = imread_bgr(record["file_name"])
    if lc.image_format == "RGB":
        img = img[:, :, ::-1]
    h0, w0 = img.shape[:2]
    min_size = lc.min_size
    if lc.min_size_choices and len(lc.min_size_choices) > 1:
        min_size = lc.min_size_choices[rng.randint(len(lc.min_size_choices))]
    nh, nw = resize_shortest_edge(h0, w0, min_size, lc.max_size)
    img = resize_bilinear(img, (nw, nh))

    boxes = np.array([a["bbox"] for a in record["annotations"]], np.float32).reshape(-1, 4)
    classes = np.array([a["category_id"] for a in record["annotations"]], np.int32)
    # xywh -> xyxy, scaled into the resized frame
    boxes = np.concatenate([boxes[:, :2], boxes[:, :2] + boxes[:, 2:]], axis=1)
    boxes *= np.array([nw / w0, nh / h0, nw / w0, nh / h0], np.float32)

    if lc.flip and rng.rand() < 0.5:
        img = img[:, ::-1, :]
        x1 = nw - boxes[:, 2]
        x2 = nw - boxes[:, 0]
        boxes = np.stack([x1, boxes[:, 1], x2, boxes[:, 3]], axis=1)

    canvas_img = np.zeros((*canvas, 3), img.dtype)
    canvas_img[:nh, :nw] = img

    g = lc.max_gt_boxes
    n = min(len(boxes), g)
    gt_boxes = np.zeros((g, 4), np.float32)
    gt_classes = np.zeros((g,), np.int32)
    gt_valid = np.zeros((g,), bool)
    gt_boxes[:n] = boxes[:n]
    gt_classes[:n] = classes[:n]
    gt_valid[:n] = True

    return {
        "image": canvas_img,
        "gt_boxes": gt_boxes,
        "gt_classes": gt_classes,
        "gt_valid": gt_valid,
        "image_id": record["image_id"],
        "input_size": np.array([nh, nw], np.float32),
        "output_size": np.array([h0, w0], np.float32),
    }


def _collate(items: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    return {
        "images": np.stack([it["image"] for it in items]),
        "gt_boxes": np.stack([it["gt_boxes"] for it in items]),
        "gt_classes": np.stack([it["gt_classes"] for it in items]),
        "gt_valid": np.stack([it["gt_valid"] for it in items]),
        "image_ids": np.array([it["image_id"] for it in items]),
        "input_sizes": np.stack([it["input_size"] for it in items]),
        "output_sizes": np.stack([it["output_size"] for it in items]),
    }


def _prepare_star(args):
    record, lc, canvas, seed = args
    return _prepare_record(record, lc, canvas, np.random.RandomState(seed))


class _Prefetcher:
    """One background thread producing items of `gen_fn()` into a bounded
    queue. An error in the producer is raised at the consumer; ``close()``
    stops the producer and joins it."""

    _END = object()

    def __init__(self, gen_fn, depth: int = 2):
        self._queue: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, args=(gen_fn,), daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Bounded put that gives up once close() raised the stop flag."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self, gen_fn):
        try:
            for item in gen_fn():
                if not self._put(item):
                    return
        except BaseException as exc:  # handed to the consumer, raised there
            self._error = exc
        finally:
            self._put(self._END)

    def __iter__(self):
        while True:
            item = self._queue.get()
            if item is self._END:
                if self._error is not None:
                    raise self._error
                return
            yield item

    def close(self) -> None:
        """Stop the producer and wait for it: drain the queue so a producer
        parked on a full one sees the stop flag."""
        self._stop.set()
        while self._thread.is_alive():
            try:
                self._queue.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.1)
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass


class _WorkerPool:
    """Ordered map() over decode work items on a thread pool: zlib, the
    C++ unfilter and numpy's resize release the interpreter lock for most of
    their work. The JAX package's 'process' backend is not ported yet."""

    def __init__(self, num_workers: int, backend: str = "thread"):
        if backend == "process":
            raise NotImplementedError(
                "DATALOADER.WORKER_BACKEND 'process' is not ported yet (ROADMAP §1, A8)")
        if backend != "thread":
            raise ValueError(
                f"DATALOADER.WORKER_BACKEND must be 'thread' or 'process', got {backend!r}")
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=max(num_workers, 1))

    def map(self, fn, items):
        return list(self._pool.map(fn, items))

    def close(self):
        self._pool.shutdown(wait=True)


class TestLoader:
    """Sequential loader; the final batch is padded by repeating the last
    image, flagged via `batch_valid`. ``close()`` stops the background
    threads of every iteration still running, then the decode pool. (The
    JAX loader's per-process shard comes with multi-process evaluation,
    ROADMAP §1 B4.)"""

    __test__ = False  # "Test" = test-set loader, not a pytest class

    def __init__(
        self,
        dataset: DatasetInfo,
        batch_size: int,
        min_size: int,
        max_size: int,
        divisibility: int = 32,
        prefetch: int = 2,
        num_workers: int = 4,
        worker_backend: str = "thread",
    ):
        self.records = dataset.load()
        self.canvas = static_canvas(
            [(r["height"], r["width"]) for r in self.records],
            min_size if isinstance(min_size, int) else max(min_size),
            max_size, divisibility,
        )
        self._pool = _WorkerPool(num_workers, worker_backend)
        self.batch_size = batch_size
        self.lc = LoaderConfig(
            min_size=min_size, max_size=max_size, divisibility=divisibility,
            max_gt_boxes=1, flip=False,
        )
        self.prefetch = prefetch
        self._prefetchers: List[_Prefetcher] = []

    def __len__(self):
        return -(-len(self.records) // self.batch_size)

    def close(self):
        """Stop every prefetch thread, then release the decode pool: a
        prefetch thread left running would submit to a pool shut down under
        it. The loader is not iterated after close()."""
        for prefetcher in self._prefetchers:
            prefetcher.close()
        self._prefetchers.clear()
        self._pool.close()

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        def gen():
            for start in range(0, len(self.records), self.batch_size):
                chunk = self.records[start : start + self.batch_size]
                valid = np.zeros((self.batch_size,), bool)
                valid[: len(chunk)] = True
                while len(chunk) < self.batch_size:
                    chunk = chunk + [chunk[-1]]
                items = self._pool.map(_prepare_star, [(r, self.lc, self.canvas, 0) for r in chunk])
                batch = _collate(items)
                batch["batch_valid"] = valid
                yield batch

        prefetcher = _Prefetcher(gen, self.prefetch)
        self._prefetchers.append(prefetcher)
        return iter(prefetcher)


class DevicePrefetcher:
    """Double-buffered host→device transfer over a batch iterator.

    A background thread turns the next batch's `keys` into tensors on
    `device` while the consumer computes on the current one. On CUDA each
    array is copied into pinned host memory and sent with
    ``non_blocking=True`` on a side stream; an event recorded there is
    handed over with the batch, the consumer's stream waits on it, and
    ``record_stream`` tells the caching allocator that the consumer's stream
    uses the tensors. On the CPU the arrays become tensors without a copy.
    Other entries (image ids, validity flags) pass through as numpy.

    Single pass: a second iteration yields nothing. A producer error is
    raised at the consumer. ``close()`` stops the thread and drops the
    batches it holds."""

    def __init__(
        self,
        batches,
        device,
        keys=("images", "input_sizes", "output_sizes"),
        depth: int = 2,
    ):
        self.device = torch.device(device)
        self._keys = keys
        self._done = False
        self._stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self._fetch = _Prefetcher(lambda: map(self._to_device, batches), depth)

    def _to_device(self, batch):
        out = dict(batch)
        event = None
        if self._stream is None:
            for k in self._keys:
                if k in out:
                    out[k] = torch.from_numpy(np.ascontiguousarray(out[k]))
        else:
            with torch.cuda.stream(self._stream):
                for k in self._keys:
                    if k in out:
                        host = torch.from_numpy(np.ascontiguousarray(out[k])).pin_memory()
                        out[k] = host.to(self.device, non_blocking=True)
                event = torch.cuda.Event()
                event.record(self._stream)
        return out, event

    def __iter__(self):
        if self._done:
            return
        try:
            for out, event in self._fetch:
                if event is not None:
                    consumer = torch.cuda.current_stream(self.device)
                    consumer.wait_event(event)
                    for k in self._keys:
                        if k in out:
                            out[k].record_stream(consumer)
                yield out
        finally:
            self._done = True

    def close(self):
        """Stop the worker and drop its buffered batches. Idempotent."""
        self._done = True
        self._fetch.close()
