"""The operation and byte counts against sums by hand."""

import pytest

from portbench.counts import convs, kernels, peaks


def test_level_positions():
    assert convs.level_positions((736, 1280)) == 92 * 160 + 46 * 80 + 23 * 40 + 12 * 20 + 6 * 10
    assert convs.level_positions((64, 64)) == 64 + 16 + 4 + 1 + 1


def test_small_canvas_by_hand():
    cs = {c.name: c for c in convs.convs((64, 64), num_classes=7)}
    # stem 7x7/2 (pad 3) on 64x64: 32x32 out; max pool to 16x16; res2 at 16x16.
    assert cs["stem.conv1"].out_hw == (32, 32)
    assert cs["stem.conv1"].macs == 32 * 32 * 64 * 3 * 49
    assert cs["res2.0.conv2"].macs == 16 * 16 * 64 * 64 * 9
    assert cs["res3.0.conv1"].out_hw == (8, 8) and cs["res5.2.conv3"].out_hw == (2, 2)
    assert cs["p6"].out_hw == (1, 1) and cs["p7"].out_hw == (1, 1)
    assert cs["cls_score.p3"].macs == 8 * 8 * 63 * 256 * 9
    assert cs["bbox_cov.p4"].macs == 4 * 4 * 36 * 256 * 9
    assert not cs["res2.2.conv3"].trainable and not cs["stem.conv1"].input_grad
    assert cs["res3.0.conv2"].input_grad and not cs["res3.0.conv1"].input_grad
    assert not cs["res3.0.shortcut"].input_grad and cs["res3.0.shortcut"].trainable


def test_inference_and_training_sums():
    cs = convs.convs((64, 64), num_classes=7)
    once = sum(c.macs for c in cs if c.part != "run")
    per_run = sum(c.macs for c in cs if c.part == "run")
    assert convs.infer_macs_per_image(cs, 10) == once + 10 * per_run
    assert convs.infer_macs_per_image(cs, 1) == sum(c.macs for c in cs)
    frozen = sum(c.macs for c in cs if c.name.startswith(("stem", "res2")))
    no_input_grad = cs_macs = sum(c.macs for c in cs if c.name in ("res3.0.conv1",
                                                                   "res3.0.shortcut"))
    total = sum(c.macs for c in cs)
    assert convs.train_macs_per_image(cs) == total + 2 * (total - frozen) - no_input_grad
    assert cs_macs > 0


def test_full_size_matches_the_published_widths():
    cs = convs.convs((736, 1280), num_classes=7)
    tower = next(c for c in cs if c.name == "cls_subnet.1.p3").macs
    assert tower == 14720 * 256 * 256 * 9
    layer = sum(c.macs for c in cs if c.name.startswith("cls_subnet.1."))
    assert layer == 19620 * 256 * 256 * 9  # 11.57 GMAC over P3-P7
    r50 = sum(c.macs for c in cs if c.name.startswith(("stem", "res")))
    assert 70e9 < r50 < 85e9
    flagship = convs.infer_macs_per_image(cs, 10)
    assert 850e9 < flagship < 950e9
    assert 180e9 < convs.infer_macs_per_image(cs, 1) < 210e9


def test_kernel_bounds():
    # K1 at the MC bank of batch 2: 10,045,440 elements each way, 0.0120 ms.
    assert kernels.k1_bytes(2, 19620) == 10045440 * 2
    assert kernels.k1_forward_bound_s(kernels.k1_bytes(2, 19620)) == pytest.approx(
        0.0120e-3, rel=5e-3)
    assert kernels.k1_backward_bound_s(kernels.k1_bytes(4, 19620)) == pytest.approx(
        0.0360e-3, rel=5e-3)
    assert kernels.focal_ops(10) == (404, 51)
    n = 4 * 176580 * 7
    assert kernels.k2_bound_s(n, 10) == pytest.approx(n * 51 / peaks.MUFU_PER_S)
    assert kernels.k2_bound_s(n, 10) == pytest.approx(0.0603e-3, rel=5e-3)
