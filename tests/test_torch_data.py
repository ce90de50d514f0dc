"""The port's data path against the JAX package's and against OpenCV.

The JAX package reads and writes images with cv2 and resizes with
``cv2.resize(INTER_LINEAR)``; the port does all three without OpenCV
(``pod_compare_tpu_torch/data/image_io.py``). Here:

* the dataset records and the synthetic dataset's json are equal (the json
  byte for byte), and the port's decode of the JAX-written PNGs equals
  ``cv2.imread``;
* the PNG reader, with its C++ unfilter and with its numpy version, equals
  ``cv2.imread(IMREAD_COLOR)`` on files cv2 wrote with each of its PNG
  filter settings, in gray, BGR and BGRA;
* JPEG, interlaced and 16-bit files raise NotImplementedError;
* the resize equals ``cv2.resize`` on random sizes, up and down. 1 LSB
  would be within the loader's contract; against OpenCV 5.0.0 the share of
  pixels that differ is 0 in every case, so the test holds it bit for bit;
* ``TestLoader`` batches equal the JAX ``TestLoader``'s (images bit for
  bit, sizes, ids and ``batch_valid`` exactly), resizing up and down;
* ``DevicePrefetcher`` keeps order, raises a producer's error at the
  consumer, closes, and yields nothing when iterated again, as
  ``tests/test_loader.py`` checks the JAX one; ``TestLoader.close`` stops
  its prefetch thread before its pool.
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

from pod_compare_tpu.data.datasets import get_dataset as jax_get_dataset
from pod_compare_tpu.data.loader import TestLoader as JaxTestLoader
from pod_compare_tpu.data.synthetic import generate_synthetic_dataset as jax_generate
from pod_compare_tpu.data.synthetic import register_synthetic as jax_register
from pod_compare_tpu_torch import native
from pod_compare_tpu_torch.data import image_io
from pod_compare_tpu_torch.data.datasets import DatasetInfo, get_dataset
from pod_compare_tpu_torch.data.loader import DevicePrefetcher, TestLoader, _WorkerPool
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


def _filter_bytes(path):
    """Filter-type bytes of the rows of a non-interlaced 8-bit PNG."""
    with open(path, "rb") as f:
        data = f.read()
    w, h, _, color = struct.unpack(">IIBB", data[16:26])
    row = 1 + w * {0: 1, 2: 3, 6: 4}[color]
    idat = b"".join(body for kind, body in image_io._chunks(data) if kind == b"IDAT")
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, row)
    return set(raw[:, 0].tolist())


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
        ref = cv2.imread(jax_file, cv2.IMREAD_COLOR)
        np.testing.assert_array_equal(image_io.imread_bgr(jax_file), ref)
        np.testing.assert_array_equal(cv2.imread(port_file, cv2.IMREAD_COLOR), ref)


@pytest.mark.parametrize("unfilter", ["native", "numpy"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("filt", list(FILTERS))
def test_png_reader_matches_cv2(tmp_path, filt, layout, unfilter):
    rng = np.random.RandomState(len(filt) * 10 + len(layout))
    img = _image(rng, (23, 31, *LAYOUTS[layout]))
    path = str(tmp_path / "x.png")
    flag, used = FILTERS[filt]
    assert cv2.imwrite(path, img, [cv2.IMWRITE_PNG_FILTER, flag])
    if used is not None:
        assert _filter_bytes(path) <= used | {0}
    else:
        assert len(_filter_bytes(path)) > 1
    fn = native.png_unfilter if unfilter == "native" else image_io.unfilter_plain
    ours = image_io.imread_bgr(path, unfilter=fn)
    np.testing.assert_array_equal(ours, cv2.imread(path, cv2.IMREAD_COLOR))


def test_png_writer_round_trips_through_cv2(tmp_path):
    rng = np.random.RandomState(5)
    for shape in ((17, 29, 3), (17, 29)):
        img = _image(rng, shape)
        path = str(tmp_path / "w.png")
        image_io.write_png(path, img)
        np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED), img)
        np.testing.assert_array_equal(image_io.imread_bgr(path),
                                      cv2.imread(path, cv2.IMREAD_COLOR))


def test_jpeg_interlaced_and_16_bit_raise(tmp_path):
    rng = np.random.RandomState(6)
    img = _image(rng, (16, 16, 3))
    jpeg = str(tmp_path / "x.jpg")
    assert cv2.imwrite(jpeg, img)
    with pytest.raises(NotImplementedError, match="JPEG"):
        image_io.imread_bgr(jpeg)
    deep = str(tmp_path / "deep.png")
    assert cv2.imwrite(deep, img.astype(np.uint16) * 257)
    with pytest.raises(NotImplementedError, match="16-bit"):
        image_io.imread_bgr(deep)
    # the same file with the IHDR's interlace byte set to Adam7
    data = bytearray(image_io.encode_png(img))
    data[28] = 1
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])) & 0xFFFFFFFF)
    with pytest.raises(NotImplementedError, match="interlaced"):
        image_io.decode_png(bytes(data))
    with pytest.raises(FileNotFoundError):
        image_io.imread_bgr(str(tmp_path / "missing.png"))


def test_unknown_filter_type_raises():
    raw = np.zeros((2, 1 + 6), np.uint8)
    raw[1, 0] = 7
    for fn in (native.png_unfilter, image_io.unfilter_plain):
        with pytest.raises(ValueError, match="row 1"):
            fn(raw.reshape(-1), 2, 6, 3)


@pytest.mark.parametrize("direction", ["up", "down", "mixed", "half"])
def test_resize_matches_cv2(direction):
    rng = np.random.RandomState({"up": 1, "down": 2, "mixed": 3, "half": 4}[direction])
    differing = total = 0
    for _ in range(25):
        h, w = rng.randint(2, 90, 2)
        if direction == "up":
            nh, nw = rng.randint(max(h, w), 200, 2)
        elif direction == "down":
            nh, nw = rng.randint(1, h + 1), rng.randint(1, w + 1)
        elif direction == "mixed":
            nh, nw = rng.randint(1, 200), rng.randint(1, 200)
        else:
            h, w = 2 * (h // 2 + 1), 2 * (w // 2 + 1)
            nh, nw = h // 2, w // 2
        img = _image(rng, (h, w, 3))
        ours = image_io.resize_bilinear(img, (nw, nh))
        theirs = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)
        diff = np.abs(ours.astype(int) - theirs.astype(int))
        assert diff.max() <= 1
        differing += int((diff > 0).sum())
        total += diff.size
    assert differing / total == 0.0, f"{differing} of {total} pixels differ"


def test_resize_at_the_flagship_geometry():
    """BDD's 720x1280 to the 750x1333 of MIN_SIZE_TEST 800, MAX 1333."""
    img = _image(np.random.RandomState(7), (720, 1280, 3))
    ours = image_io.resize_bilinear(img, (1333, 750))
    np.testing.assert_array_equal(ours, cv2.resize(img, (1333, 750),
                                                   interpolation=cv2.INTER_LINEAR))


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


def test_process_backend_is_refused():
    with pytest.raises(NotImplementedError, match="process"):
        _WorkerPool(2, "process")


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
