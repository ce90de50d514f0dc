"""The port's data path against the JAX package's.

Both packages read images with ``cv2.imread(IMREAD_COLOR)``, resize them
with ``cv2.resize(INTER_LINEAR)`` and write them with ``cv2.imwrite``, so on
one machine the two must agree bit for bit, and every comparison here is
exact (no tolerance):

* the dataset records and the synthetic dataset's files (json and images
  byte for byte);
* ``_prepare_record`` of both packages on the same file, for every kind of
  image a dataset may hold: PNG in gray, BGR and BGRA under each of cv2's
  six filter settings, 16-bit, palette and interlaced PNG, baseline and
  progressive JPEG, a JPEG with each EXIF orientation 1-8 (which
  IMREAD_COLOR applies) and a gray JPEG; each as a training record (flip
  and MIN_SIZE_TRAIN choice drawn from a seed) and as a test record;
* ``TrainLoader`` batches, bit for bit and in order, for several seeds,
  batch sizes, one or three MIN_SIZE_TRAIN choices and flips on or off;
  ``iter_from(k)``; the process backend against the thread backend;
* ``TestLoader`` batches (images, sizes, ids and ``batch_valid``);
* ``DevicePrefetcher`` keeps order, raises a producer's error at the
  consumer, closes, and yields nothing when iterated again, as
  ``tests/test_loader.py`` checks the JAX one; the loaders' ``close`` stops
  their prefetch threads before their pools.
"""

import json
import os
import struct
import time
import zlib

import cv2
import numpy as np
import pytest
import torch

from pod_compare_tpu.data import loader as jax_loader
from pod_compare_tpu.data.datasets import get_dataset as jax_get_dataset
from pod_compare_tpu.data.loader import TestLoader as JaxTestLoader
from pod_compare_tpu.data.loader import TrainLoader as JaxTrainLoader
from pod_compare_tpu.data.synthetic import generate_synthetic_dataset as jax_generate
from pod_compare_tpu.data.synthetic import register_synthetic as jax_register
from pod_compare_tpu_torch import native
from pod_compare_tpu_torch.data import loader
from pod_compare_tpu_torch.data.datasets import DatasetInfo, get_dataset
from pod_compare_tpu_torch.data.loader import DevicePrefetcher, TestLoader, TrainLoader
from pod_compare_tpu_torch.data.synthetic import generate_synthetic_dataset, register_synthetic

FILTERS = {
    "none": (cv2.IMWRITE_PNG_FILTER_NONE, {0}),
    "sub": (cv2.IMWRITE_PNG_FILTER_SUB, {1}),
    "up": (cv2.IMWRITE_PNG_FILTER_UP, {2}),
    "avg": (cv2.IMWRITE_PNG_FILTER_AVG, {3}),
    "paeth": (cv2.IMWRITE_PNG_FILTER_PAETH, {4}),
    "all": (cv2.IMWRITE_PNG_ALL_FILTERS, None),
}
LAYOUTS = {"gray": (), "bgr": (3,), "bgra": (4,)}


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """The same synthetic dataset written by both packages, registered in
    both registries under one name."""
    root = tmp_path_factory.mktemp("synth")
    kw = dict(num_images=7, image_size=(64, 80), num_classes=3, max_objects=3, seed=3)
    jax_register(str(root / "jax"), "synth_data", **kw)
    register_synthetic(str(root / "port"), "synth_data", **kw)
    return root


def _image(rng, shape):
    img = (rng.rand(*shape) * 255).astype(np.uint8)
    img[2:6, 3:9] = 90  # a flat patch, where the predictors differ most
    return img


def test_dataset_records_match_jax(synth):
    ours, theirs = get_dataset("synth_data"), jax_get_dataset("synth_data")
    strip = lambda recs, root: [dict(r, file_name=os.path.relpath(r["file_name"], root))
                                for r in recs]
    assert strip(ours.load(), str(synth / "port")) == strip(theirs.load(), str(synth / "jax"))
    # crowd boxes and unknown categories are dropped alike
    with open(theirs.json_file) as f:
        coco = json.load(f)
    coco["annotations"][0]["iscrowd"] = 1
    coco["annotations"][1]["category_id"] = 99
    path = synth / "edited.json"
    path.write_text(json.dumps(coco))
    args = ("edited", str(path), str(synth), ["a", "b", "c"], {1: 0, 2: 1, 3: 2})
    from pod_compare_tpu.data.datasets import DatasetInfo as JaxDatasetInfo

    assert DatasetInfo(*args).load() == JaxDatasetInfo(*args).load()


def test_synthetic_json_is_byte_identical_and_pixels_equal(synth):
    with open(synth / "jax" / "synth_data_coco.json", "rb") as a, \
            open(synth / "port" / "synth_data_coco.json", "rb") as b:
        assert a.read() == b.read()
    names = sorted(os.listdir(synth / "jax" / "synth_data_images"))
    assert len(names) == 7
    for name in names:
        jax_file = str(synth / "jax" / "synth_data_images" / name)
        port_file = str(synth / "port" / "synth_data_images" / name)
        with open(jax_file, "rb") as a, open(port_file, "rb") as b:
            assert a.read() == b.read(), name
        np.testing.assert_array_equal(loader.load_image_bgr(port_file),
                                      jax_loader.load_image_bgr(jax_file))
    with pytest.raises(FileNotFoundError):
        loader.load_image_bgr(str(synth / "missing.png"))


FILTERS = {
    "none": cv2.IMWRITE_PNG_FILTER_NONE,
    "sub": cv2.IMWRITE_PNG_FILTER_SUB,
    "up": cv2.IMWRITE_PNG_FILTER_UP,
    "avg": cv2.IMWRITE_PNG_FILTER_AVG,
    "paeth": cv2.IMWRITE_PNG_FILTER_PAETH,
    "all": cv2.IMWRITE_PNG_ALL_FILTERS,
}
LAYOUTS = {"gray": (), "bgr": (3,), "bgra": (4,)}
SHAPE = (23, 37)  # odd and not square: an EXIF rotation changes the decoded shape
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))  # (x0, y0, dx, dy) of each pass


def _png_file(path, width, height, color_type, raw, plte=None, interlace=0):
    """An 8-bit PNG from its unfiltered rows (each already prefixed with
    filter byte 0): cv2 writes neither palette nor interlaced files."""
    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))
    ihdr = struct.pack(">IIBBBBB", width, height, 8, color_type, 0, 0, interlace)
    data = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
    if plte is not None:
        data += chunk(b"PLTE", plte.tobytes())
    data += chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(data)


def _rows(pixels):
    """Filter-0 scanlines of an (h, w[, c]) uint8 array."""
    flat = pixels.reshape(pixels.shape[0], -1)
    return np.concatenate([np.zeros((flat.shape[0], 1), np.uint8), flat], axis=1).tobytes()


def _exif_jpeg(path, img, orientation):
    """A baseline JPEG of `img` with an APP1 Exif segment holding only the
    Orientation tag (0x0112, one SHORT), little-endian TIFF."""
    ok, buf = cv2.imencode(".jpg", img)
    assert ok
    tiff = (b"II*\x00" + struct.pack("<I", 8) + struct.pack("<H", 1)
            + struct.pack("<HHIHH", 0x0112, 3, 1, orientation, 0) + struct.pack("<I", 0))
    body = b"Exif\x00\x00" + tiff
    data = buf.tobytes()
    with open(path, "wb") as f:
        f.write(data[:2] + b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body + data[2:])


def _write_kind(kind, path, rng):
    """Write an image of `kind` to `path` (its suffix set here); returns the
    path."""
    h, w = SHAPE
    fmt, _, rest = kind.partition("-")
    if fmt == "png" and rest in ("16bit", "palette", "interlaced"):
        path += ".png"
        if rest == "16bit":
            assert cv2.imwrite(path, (rng.rand(h, w, 3) * 65535).astype(np.uint16))
        elif rest == "palette":
            plte = (rng.rand(12, 3) * 255).astype(np.uint8)
            _png_file(path, w, h, 3, _rows(rng.randint(0, 12, (h, w)).astype(np.uint8)), plte)
        else:
            rgb = _image(rng, (h, w, 3))
            raw = b"".join(_rows(rgb[y0::dy, x0::dx]) for x0, y0, dx, dy in ADAM7
                           if rgb[y0::dy, x0::dx].size)
            _png_file(path, w, h, 2, raw, interlace=1)
        return path
    if fmt == "png":
        layout, filt = rest.split("-")
        path += ".png"
        img = _image(rng, (h, w, *LAYOUTS[layout]))
        assert cv2.imwrite(path, img, [cv2.IMWRITE_PNG_FILTER, FILTERS[filt]])
        return path
    path += ".jpg"
    img = _image(rng, (h, w, 3))
    if rest.startswith("exif"):
        _exif_jpeg(path, img, int(rest[len("exif"):]))
    elif rest == "gray":
        assert cv2.imwrite(path, img[:, :, 1])
    else:
        flags = [cv2.IMWRITE_JPEG_PROGRESSIVE, int(rest == "progressive"),
                 cv2.IMWRITE_JPEG_QUALITY, 90]
        assert cv2.imwrite(path, img, flags)
    return path


IMAGE_KINDS = (
    [f"png-{layout}-{filt}" for layout in LAYOUTS for filt in FILTERS]
    + ["png-16bit", "png-palette", "png-interlaced", "jpeg-baseline", "jpeg-progressive",
       "jpeg-gray"]
    + [f"jpeg-exif{o}" for o in range(1, 9)]
)


def _configs(mode):
    """Both packages' LoaderConfig and the canvas of a training record (flip,
    three MIN_SIZE_TRAIN choices) or of a test record, as the loaders make
    them."""
    if mode == "train":
        kw = dict(min_size=56, max_size=96, max_gt_boxes=5, flip=True,
                  min_size_choices=(24, 40, 56))
    else:
        kw = dict(min_size=40, max_size=96, max_gt_boxes=1, flip=False)
    return loader.LoaderConfig(**kw), jax_loader.LoaderConfig(**kw), (96, 96)


@pytest.mark.parametrize("mode", ["train", "test"])
@pytest.mark.parametrize("kind", IMAGE_KINDS)
def test_prepare_record_matches_jax(tmp_path, kind, mode):
    rng = np.random.RandomState(IMAGE_KINDS.index(kind))
    path = _write_kind(kind, str(tmp_path / "img"), rng)
    record = {"file_name": path, "image_id": 7, "height": SHAPE[0], "width": SHAPE[1],
              "annotations": [{"bbox": [2.5, 3.0, 10.0, 8.0], "category_id": 1},
                              {"bbox": [12.0, 1.0, 20.0, 15.5], "category_id": 0}]}
    ours_lc, theirs_lc, canvas = _configs(mode)
    decoded = loader.load_image_bgr(path)
    if kind in ("jpeg-exif5", "jpeg-exif6", "jpeg-exif7", "jpeg-exif8"):
        assert decoded.shape == (SHAPE[1], SHAPE[0], 3)  # the orientation was applied
    else:
        assert decoded.shape == (*SHAPE, 3)
    flips = set()
    for seed in range(6) if mode == "train" else (0,):
        ours = loader._prepare_record(record, ours_lc, canvas, np.random.RandomState(seed))
        theirs = jax_loader._prepare_record(record, theirs_lc, canvas,
                                            np.random.RandomState(seed))
        assert set(ours) == set(theirs)
        for k, v in theirs.items():
            assert np.asarray(ours[k]).dtype == np.asarray(v).dtype, k
            np.testing.assert_array_equal(ours[k], v, err_msg=k)
        # the draws, in the loaders' order: the size choice, then the flip
        draws = np.random.RandomState(seed)
        min_size = ours_lc.min_size
        if mode == "train":
            min_size = ours_lc.min_size_choices[draws.randint(3)]
        flipped = mode == "train" and draws.rand() < 0.5
        nh, nw = loader.resize_shortest_edge(*decoded.shape[:2], min_size, ours_lc.max_size)
        resized = cv2.resize(decoded, (nw, nh), interpolation=cv2.INTER_LINEAR)
        np.testing.assert_array_equal(ours["image"][:nh, :nw],
                                      resized[:, ::-1] if flipped else resized)
        flips.add(flipped)
    if mode == "train":
        assert flips == {True, False}  # the seeds draw flips both ways


@pytest.mark.parametrize("flip", [True, False])
@pytest.mark.parametrize("choices", [(64,), (48, 64, 80)])
@pytest.mark.parametrize("batch", [2, 3])
@pytest.mark.parametrize("seed", [0, 5])
def test_train_loader_batches_match_jax(synth, seed, batch, choices, flip):
    """Seven records, so batches of 2 or 3 leave one or two records out of
    each epoch; eight batches span three or four epochs."""
    kw = dict(batch_size=batch, min_size=choices, max_size=1333, seed=seed, flip=flip,
              num_workers=2, max_gt_boxes=4)
    ours = TrainLoader(get_dataset("synth_data"), **kw)
    theirs = JaxTrainLoader(jax_get_dataset("synth_data"), **kw)
    assert ours.canvas == theirs.canvas
    a, b = ours.iter_from(0), theirs.iter_from(0)
    for _ in range(8):
        x, y = next(a), next(b)
        assert set(x) == set(y)
        for k in y:
            assert x[k].dtype == y[k].dtype, k
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)
    ours.close()
    theirs.close()


@pytest.mark.parametrize("start", [1, 3, 4, 7])
def test_iter_from_equals_the_uninterrupted_stream(synth, start):
    """iter_from(k) replays the draws of the first k batches without
    decoding; its batches are batches k, k+1, ... of the whole stream, and
    the JAX loader's iter_from(k)."""
    kw = dict(batch_size=3, min_size=(48, 64, 80), max_size=1333, seed=11, num_workers=2)
    whole = TrainLoader(get_dataset("synth_data"), **kw)
    stream = whole.iter_from(0)
    batches = [next(stream) for _ in range(start + 2)]
    whole.close()
    resumed = TrainLoader(get_dataset("synth_data"), **kw)
    theirs = JaxTrainLoader(jax_get_dataset("synth_data"), **kw).iter_from(start)
    for i, got in enumerate(zip(resumed.iter_from(start), theirs)):
        if i == 2:
            break
        for k in got[0]:
            np.testing.assert_array_equal(got[0][k], batches[start + i][k], err_msg=k)
            np.testing.assert_array_equal(got[1][k], batches[start + i][k], err_msg=k)
    resumed.close()


@pytest.mark.parametrize("which", ["train", "test"])
def test_process_backend_equals_thread_backend(synth, which):
    """Two spawned worker processes give the thread pool's batches, and
    close() ends them."""
    batches = {}
    for backend in ("thread", "process"):
        if which == "train":
            ld = TrainLoader(get_dataset("synth_data"), batch_size=2, min_size=(48, 64),
                             max_size=1333, seed=2, num_workers=2, worker_backend=backend)
            stream = ld.iter_from(0)
            batches[backend] = [next(stream) for _ in range(4)]
        else:
            ld = TestLoader(get_dataset("synth_data"), batch_size=3, min_size=56, max_size=1333,
                            num_workers=2, worker_backend=backend)
            batches[backend] = list(ld)
        if backend == "process":
            workers = list(ld._pool._pool._pool)
            assert len(workers) == 2 and all(p.is_alive() for p in workers)
        ld.close()
    assert not any(p.is_alive() for p in workers)
    for a, b in zip(batches["thread"], batches["process"]):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_unknown_worker_backend_raises():
    with pytest.raises(ValueError, match="WORKER_BACKEND"):
        loader._WorkerPool(2, "fiber")


@pytest.mark.parametrize("min_size,batch", [(72, 3), (48, 2), (64, 4)])
def test_test_loader_batches_match_jax(synth, min_size, batch):
    kw = dict(batch_size=batch, min_size=min_size, max_size=1333, num_workers=2)
    ours = TestLoader(get_dataset("synth_data"), **kw)
    theirs = JaxTestLoader(jax_get_dataset("synth_data"), **kw)
    assert ours.canvas == theirs.canvas and len(ours) == len(theirs)
    a_batches, b_batches = list(ours), list(theirs)
    assert len(a_batches) == len(b_batches) == -(-7 // batch)
    for a, b in zip(a_batches, b_batches):
        assert set(a) == set(b)
        for k in b:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert a_batches[-1]["batch_valid"].sum() == 7 - batch * (len(a_batches) - 1)
    ours.close()
    theirs.close()


def test_device_prefetcher_order_content_and_errors(synth):
    loader = TestLoader(get_dataset("synth_data"), batch_size=2, min_size=48, max_size=1333)
    direct = list(iter(loader))
    fetched = list(DevicePrefetcher(iter(loader), "cpu"))
    assert len(fetched) == len(direct) == 4
    for a, b in zip(direct, fetched):
        assert isinstance(b["images"], torch.Tensor)
        np.testing.assert_array_equal(b["images"].numpy(), a["images"])
        np.testing.assert_array_equal(b["input_sizes"].numpy(), a["input_sizes"])
        np.testing.assert_array_equal(b["image_ids"], a["image_ids"])
        assert isinstance(b["image_ids"], np.ndarray)
    loader.close()

    def boom():
        yield direct[0]
        raise RuntimeError("decode exploded")

    it = iter(DevicePrefetcher(boom(), "cpu"))
    next(it)
    with pytest.raises(RuntimeError, match="decode exploded"):
        next(it)


def test_device_prefetcher_close_and_reiterate(synth):
    loader = TestLoader(get_dataset("synth_data"), batch_size=1, min_size=48, max_size=1333)
    pf = DevicePrefetcher(iter(loader), "cpu", depth=1)
    it = iter(pf)
    next(it)  # abandoned after one batch, its worker parked on the full queue
    pf.close()
    assert not pf._fetch._thread.is_alive()
    assert pf._fetch._queue.empty()
    pf.close()  # idempotent
    assert list(pf) == []
    loader.close()

    loader2 = TestLoader(get_dataset("synth_data"), batch_size=2, min_size=48, max_size=1333)
    pf2 = DevicePrefetcher(iter(loader2), "cpu")
    assert len(list(pf2)) == 4
    assert list(pf2) == []
    loader2.close()


def test_loader_close_stops_its_prefetch_thread_before_its_pool(synth):
    """The JAX loader shuts its pool down under a live prefetch thread; the
    port's close() stops the thread first, so nothing is submitted to a
    closed pool and no thread outlives the loader."""
    loader = TestLoader(get_dataset("synth_data"), batch_size=1, min_size=48, max_size=1333,
                        prefetch=1)
    it = iter(loader)
    next(it)
    time.sleep(0.2)  # let the producer fill the queue and park
    threads = [p._thread for p in loader._prefetchers]
    loader.close()
    assert threads and not any(t.is_alive() for t in threads)
    assert loader._pool._pool._shutdown


def test_failed_native_build_raises(tmp_path, monkeypatch):
    (tmp_path / "src").mkdir()
    for name in native.SOURCES:
        (tmp_path / "src" / name).write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE_DIR", str(tmp_path / "src"))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()
    assert not any(p.suffix == ".so" for p in (tmp_path / "build").iterdir())


def test_generate_is_deterministic_in_its_seed(tmp_path):
    a = generate_synthetic_dataset(str(tmp_path / "a"), num_images=2, seed=4)
    b = jax_generate(str(tmp_path / "b"), num_images=2, seed=4)
    with open(a[0]) as fa, open(b[0]) as fb:
        assert json.load(fa) == json.load(fb)
