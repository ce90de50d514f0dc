"""Input pipeline: decode → resize → flip → pad-to-static-canvas → batch.

The port's counterpart of ``pod_compare_tpu/data/loader.py``, with the same
geometry, the same random draws and the same batches, bit for bit: every
image is read with ``cv2.imread(IMREAD_COLOR)`` (PNG or JPEG, EXIF
orientation applied), resized with ``cv2.resize(INTER_LINEAR)`` by
detectron2's shortest-edge rule and padded onto one canvas computed from
the dataset's image sizes; ground truth is padded to a fixed box count with
a validity mask.

``TrainLoader`` yields an infinite shuffled stream (random horizontal
flips, "choice" sampling over MIN_SIZE_TRAIN) that ``iter_from(k)`` resumes
at batch k by replaying the random draws; ``TestLoader`` yields the dataset
once in order. A pool of threads (cv2 releases the interpreter lock while
it decodes and resizes) or of spawned processes prepares the images, a
background thread keeps batches ready, and ``DevicePrefetcher`` copies the
next batch to the card from pinned memory on a side CUDA stream while the
current one runs.
"""

import concurrent.futures
import multiprocessing
import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import cv2
import numpy as np
import torch

from pod_compare_tpu_torch.data.datasets import DatasetInfo
from pod_compare_tpu_torch.parallel.mesh import BatchShard


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


def load_image_bgr(path: str) -> np.ndarray:
    """(H, W, 3) uint8 BGR image (the reference's INPUT.FORMAT), as
    ``cv2.imread(IMREAD_COLOR)`` returns it. It stays uint8 through resize,
    pad and batch; the model normalises on the device."""
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    return img


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
    img = load_image_bgr(record["file_name"])
    if lc.image_format == "RGB":
        img = img[:, :, ::-1]
    h0, w0 = img.shape[:2]
    min_size = lc.min_size
    if lc.min_size_choices and len(lc.min_size_choices) > 1:
        min_size = lc.min_size_choices[rng.randint(len(lc.min_size_choices))]
    nh, nw = resize_shortest_edge(h0, w0, min_size, lc.max_size)
    img = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)

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


def _process_worker_init():
    # One OpenCV thread per worker process: the pool is the parallelism, and
    # cv2's own threads would oversubscribe the host's cores.
    cv2.setNumThreads(0)


class _WorkerPool:
    """Ordered map() over decode work items.

    'thread': cv2 releases the interpreter lock while it decodes and resizes,
    so threads overlap that work with each other and with the device.
    'process': a pool of spawned worker processes (spawn, not fork: the
    parent holds CUDA's threads). Work items cross as small (record, config,
    canvas, seed) tuples and prepared canvases come back pickled; each
    worker imports this module, and with it torch, when it starts, and
    nothing of CUDA."""

    def __init__(self, num_workers: int, backend: str = "thread"):
        if backend not in ("thread", "process"):
            raise ValueError(
                f"DATALOADER.WORKER_BACKEND must be 'thread' or 'process', got {backend!r}")
        self.backend = backend
        workers = max(num_workers, 1)
        if backend == "process":
            self._pool = multiprocessing.get_context("spawn").Pool(
                workers, initializer=_process_worker_init)
        else:
            self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=workers)

    def map(self, fn, items):
        if self.backend == "process":
            return self._pool.map(fn, items, chunksize=1)
        return list(self._pool.map(fn, items))

    def close(self):
        """Release the threads or processes; the caller has stopped every
        producer that submits work (``_PooledLoader.close``), so nothing is
        in flight."""
        if self.backend == "process":
            self._pool.close()
            self._pool.join()
        else:
            self._pool.shutdown(wait=True)


class _PooledLoader:
    """A worker pool and the prefetch threads of the iterations over it.
    ``close()`` stops every prefetch thread it started, then the pool: a
    prefetch thread left running would submit to a pool shut down under it
    (the JAX loaders' race). A loader is not iterated after close()."""

    def __init__(self, num_workers: int, worker_backend: str, prefetch: int):
        self._pool = _WorkerPool(num_workers, worker_backend)
        self.prefetch = prefetch
        self._prefetchers: List[_Prefetcher] = []

    def _stream(self, gen) -> Iterator[Dict[str, np.ndarray]]:
        prefetcher = _Prefetcher(gen, self.prefetch)
        self._prefetchers.append(prefetcher)
        return iter(prefetcher)

    def close(self):
        for prefetcher in self._prefetchers:
            prefetcher.close()
        self._prefetchers.clear()
        self._pool.close()


class TrainLoader(_PooledLoader):
    """Infinite shuffled loader with a static canvas and padded ground truth
    (the reference's build_detection_train_loader). Records without an
    annotation are dropped.

    The random stream is the JAX loader's: ``RandomState(seed)`` draws one
    permutation per epoch and one uniform vector per batch; item i of a
    batch is prepared with ``RandomState(int(f_i * 2**31) & 0x7FFFFFFF)``,
    which draws its MIN_SIZE_TRAIN choice (when there are several), then
    its flip.

    With `process_count` W > 1 the stream stays that of the global batch of
    `batch_size` images, drawn alike in every process, and process r
    prepares and yields only its rows [r·B/W, (r+1)·B/W) of each batch
    (``parallel.BatchShard``): the processes' batches, in rank order, are the
    one-process batch row for row. A batch that W does not divide raises."""

    def __init__(
        self,
        dataset: DatasetInfo,
        batch_size: int,
        min_size,
        max_size: int,
        divisibility: int = 32,
        max_gt_boxes: int = 100,
        seed: int = 0,
        canvas: Optional[Tuple[int, int]] = None,
        prefetch: int = 2,
        num_workers: int = 4,
        flip: bool = True,
        worker_backend: str = "thread",
        process_index: int = 0,
        process_count: int = 1,
    ):
        self.records = [r for r in dataset.load() if r["annotations"]]
        if not self.records:
            raise ValueError(f"Dataset {dataset.name} has no annotated images")
        self.batch_size = batch_size
        self.shard = BatchShard.of(batch_size, process_index, process_count)
        # `min_size` is an int or the MIN_SIZE_TRAIN tuple, one choice per
        # image; the canvas covers the largest.
        choices = (tuple(int(m) for m in min_size) if isinstance(min_size, (tuple, list))
                   else (int(min_size),))
        self.lc = LoaderConfig(
            min_size=max(choices), max_size=max_size, divisibility=divisibility,
            max_gt_boxes=max_gt_boxes, flip=flip, min_size_choices=choices,
        )
        self.canvas = canvas or static_canvas(
            [(r["height"], r["width"]) for r in self.records],
            max(choices), max_size, divisibility,
        )
        self.seed = seed
        super().__init__(num_workers, worker_backend, prefetch)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self.iter_from(0)

    def iter_from(self, start_iter: int) -> Iterator[Dict[str, np.ndarray]]:
        """The infinite stream from batch `start_iter` on. The batches before
        it are skipped by replaying their random draws without decoding, so
        a run resumed at step k consumes the batches an uninterrupted run
        would."""
        def gen():
            rng = np.random.RandomState(self.seed)
            skip = int(start_iter)
            while True:
                order = rng.permutation(len(self.records))
                for start in range(0, len(order) - self.batch_size + 1, self.batch_size):
                    draws = rng.rand(self.batch_size)
                    if skip > 0:
                        skip -= 1
                        continue
                    rows = slice(self.shard.first, self.shard.first + self.shard.size)
                    items = self._pool.map(_prepare_star, [
                        (self.records[i], self.lc, self.canvas, int(f * 2 ** 31) & 0x7FFFFFFF)
                        for i, f in zip(order[start:start + self.batch_size][rows], draws[rows])
                    ])
                    yield _collate(items)

        return self._stream(gen)


class TestLoader(_PooledLoader):
    """Sequential loader; the final batch is padded by repeating the last
    image, flagged in `batch_valid`.

    With `process_count` > 1, process `process_index` takes the strided
    shard ``records[process_index::process_count]`` (the JAX loader's
    shard), on the canvas of the whole dataset, so that every process runs
    the same shapes; ``parallel.gather_process_results`` gathers their
    json."""

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
        process_index: int = 0,
        process_count: int = 1,
    ):
        self.records = dataset.load()
        self.canvas = static_canvas(
            [(r["height"], r["width"]) for r in self.records],
            min_size if isinstance(min_size, int) else max(min_size),
            max_size, divisibility,
        )
        self.records = self.records[process_index::process_count]
        self.batch_size = batch_size
        self.lc = LoaderConfig(
            min_size=min_size, max_size=max_size, divisibility=divisibility,
            max_gt_boxes=1, flip=False,
        )
        super().__init__(num_workers, worker_backend, prefetch)

    def __len__(self):
        return -(-len(self.records) // self.batch_size)

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

        return self._stream(gen)


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
