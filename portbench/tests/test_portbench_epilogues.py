"""The FrozenBN epilogue's byte count (``counts/epilogues.py``) and its
roofline reader (``metrics/bnact_roofline_pct.train.py``) on synthetic
records: R50's bytes from a formula of its stages, X101-32x8d's at batch
16, and the reader's share, which is None for a program without the
kernel (the parent of the change that added it)."""

import pytest

from portbench.counts import epilogues, peaks, resnets
from portbench.harness import bench, trace as tr

FORWARD = "void (anonymous namespace)::pod_frozen_bn_forward<__nv_bfloat16, true>(x)"
BACKWARD = "void (anonymous namespace)::pod_frozen_bn_backward<__nv_bfloat16, true>(x)"
CELLS = ("dropout_train_b4", "x101_dropout_train_b16")


def _convs(cell):
    c = bench.load_cell(cell)
    return resnets.model_convs(c.config["canvas"], c.config["model"])


def test_r50_bytes_follow_its_stages():
    """R50 at 736x1280 (stride in the 1x1): a block's three epilogues cover
    mid, mid and cout = 4 mid channels at its stage's size, 1.5 cout in
    all; forward 4 B an element and 2 B more of conv3's, 8 B x cout x hw;
    backward 6 B and 2 B, 11 B x cout x hw, in res3-res5 only. The stem's
    epilogue: 64 channels at 368x640, forward only."""
    stages = [(3, 256, 184 * 320), (4, 512, 92 * 160), (6, 1024, 46 * 80), (3, 2048, 23 * 40)]
    forward = 4 * 64 * 368 * 640 + sum(8 * n * c * hw for n, c, hw in stages)
    backward = sum(11 * n * c * hw for n, c, hw in stages[1:])
    assert epilogues.step_bytes(_convs("dropout_train_b4"), 1) == (forward, backward)
    assert epilogues.step_bytes(_convs("dropout_train_b4"), 4) == (4 * forward, 4 * backward)


def test_x101_bytes_at_batch_16():
    forward, backward = epilogues.step_bytes(_convs("x101_dropout_train_b16"), 16)
    assert (forward, backward) == (41_059_614_720, 42_988_994_560)
    assert (forward + backward) / peaks.HBM_BYTES_PER_S == pytest.approx(0.025089, abs=1e-6)


def _record(cell, trace):
    c = bench.load_cell(cell)
    return {"kind": "train", "cell": c, "batch": int(c.traffic["batch"]), "trace": trace}


@pytest.mark.parametrize("cell", CELLS)
def test_bnact_roofline_reader(cell):
    read = bench.load_module("metrics", "bnact_roofline_pct.train").read
    c = bench.load_cell(cell)
    steps = int(c.traffic["profile_steps"])
    least_us = sum(epilogues.step_bytes(_convs(cell), int(c.traffic["batch"]))) / \
        peaks.HBM_BYTES_PER_S * 1e6
    # The kernels take twice their bound over the steps profiled: 50%.
    t = tr.Trace(device=[(FORWARD, 0.0, steps * least_us),
                         (BACKWARD, 5e6, 5e6 + steps * least_us), ("other", 0.0, 9e6)],
                 spans=[], window=(0.0, 1e7))
    assert read(_record(cell, t)) == pytest.approx(50.0)
    no_k3 = tr.Trace(device=[("other", 0.0, 9e6)], spans=[], window=(0.0, 1e7))
    assert read(_record(cell, no_k3)) is None
    assert read(_record(cell, None)) is None
    assert read({**_record(cell, t), "kind": "infer"}) is None
    entry = next(m for m in c.per_layer if m["name"] == "bnact_roofline_pct.train")
    assert entry["moves"] == "train_img_per_s" and entry["layer"] == "kernels"
