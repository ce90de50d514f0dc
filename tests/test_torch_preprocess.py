"""``ops/preprocess.py::resize_and_pad`` against the JAX package's.

The same float32 pixels (0-255, from a seeded numpy generator) go through
both functions at BDD's 720x1280 and KITTI's 375x1242 under the test
sizes (MIN 800, MAX 1333: enlarged to 750x1333 and 402x1333), at BDD's
training size (720x1280 kept), the JAX tests' geometry and four more
enlarging and shrinking pairs, with and without antialias.

Tolerance: 1e-3 absolute on the 0-255 scale (4e-6 of the largest value).
Both compute the same separable triangle filter in float32, but round its
weights at other points; the largest gap measured over these cases is
4.7e-4 (a 1.5x enlargement), 3.1e-5 at the BDD and KITTI sizes, and the
kept size is exact. Outside the resized image the canvas is zero.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pod_compare_tpu.ops.preprocess import resize_and_pad as jax_resize_and_pad
from pod_compare_tpu_torch.ops.preprocess import resize_and_pad
from test_torch_modes import few_threads  # noqa: F401  (module fixture)

TOL = 1e-3
CASES = [  # source (h, w), min_size, max_size, canvas
    ((720, 1280), 800, 1333, (768, 1344)),  # BDD at the test size
    ((375, 1242), 800, 1333, (416, 1344)),  # KITTI at the test size
    ((720, 1280), 720, 1333, (736, 1280)),  # BDD at the training size: kept
    ((100, 200), 50, 90, (64, 96)),  # the JAX test's: max_size caps it
    ((90, 160), 60, 1333, (64, 128)),
    ((60, 100), 90, 1333, (96, 160)),
    ((100, 180), 37, 1333, (64, 96)),
]


@pytest.mark.parametrize("antialias", [True, False])
@pytest.mark.parametrize("source,min_size,max_size,canvas", CASES)
def test_resize_and_pad_matches_jax(source, min_size, max_size, canvas, antialias):
    x = (np.random.RandomState(sum(source)).rand(2, *source, 3) * 255).astype(np.float32)
    want, want_size = jax_resize_and_pad(jnp.asarray(x), source, min_size, max_size, canvas,
                                         antialias=antialias)
    got, size = resize_and_pad(torch.from_numpy(x), source, min_size, max_size, canvas,
                               antialias=antialias)
    assert size == tuple(int(v) for v in want_size)
    assert got.shape == (2, *canvas, 3) and got.dtype == torch.float32
    err = np.abs(got.numpy() - np.asarray(want)).max()
    assert err <= TOL, f"max abs {err}"
    assert not got[:, size[0]:].any() and not got[:, :, size[1]:].any()
    if size == tuple(source):
        assert torch.equal(got[:, :size[0], :size[1]], torch.from_numpy(x))


def test_uint8_pixels_are_resized_in_float32():
    x = (np.random.RandomState(3).rand(1, 90, 160, 3) * 255).astype(np.uint8)
    got, size = resize_and_pad(torch.from_numpy(x), (90, 160), 60, 1333, (64, 128))
    want, _ = resize_and_pad(torch.from_numpy(x.astype(np.float32)), (90, 160), 60, 1333,
                             (64, 128))
    assert got.dtype == torch.float32 and torch.equal(got, want)


def test_a_canvas_too_small_or_another_source_size_raises():
    x = torch.zeros(1, 90, 160, 3)
    with pytest.raises(ValueError, match="exceeds canvas"):
        resize_and_pad(x, (90, 160), 60, 1333, (32, 128))
    with pytest.raises(ValueError, match="source size"):
        resize_and_pad(x, (90, 161), 60, 1333, (64, 128))
