"""The ResNet/ResNeXt configuration of the benchmark: its counts, its plain
reference and its training cell, on the CPU.

At R50's keys (depth 50, one group of 64, the stride in the 1x1, PIXEL_STD
1) ``counts/resnets.py`` gives ``counts/convs.py``'s list and
``reference/resnets.py`` ``reference/model.py``'s forward and training
steps, to the bit; at X101-32x8d the counts are the published model's.
The cell runs at a small size, its faults and controls as the R50 training
cell's, and its readers on synthetic records.
"""

import json

import pytest
import torch

from conftest import small
from portbench import calibrate, run
from portbench.counts import convs, peaks, resnets as cres
from portbench.harness import bench, gen, trace as tr
from portbench.harness.trace import Spans
from portbench.reference import model, resnets, train as rtrain

CELL = "x101_dropout_train_b16"
MODEL = bench.load_cell(CELL).config["model"]
HEAD = dict(num_classes=7, num_anchors=9, num_convs=4, cls_var=True, bbox_cov_dims=4)


def test_counts_at_r50_are_convs_py():
    for canvas in ((64, 64), (736, 1280)):
        ours = cres.model_convs(canvas, HEAD)
        theirs = convs.convs(canvas, 7)
        assert [tuple(c[:8]) for c in ours] == [tuple(c) for c in theirs]
        assert [c.macs for c in ours] == [c.macs for c in theirs]
        assert convs.train_macs_per_image(ours) == convs.train_macs_per_image(theirs)
        assert not cres.grouped(ours)


def test_counts_of_x101_32x8d():
    cs = cres.model_convs((736, 1280), MODEL)
    backbone = [c for c in cs if c.name.startswith(("stem.", "res"))]
    assert sum(c.cout * (c.cin // c.groups) * c.k ** 2 for c in backbone) == 86_539_456
    assert sum(c.macs for c in backbone) == 308_143_063_040
    assert convs.train_macs_per_image(backbone) == 861_392_732_160
    assert convs.train_macs_per_image(cs) == 1_213_799_516_160
    g = cres.grouped(cs)
    assert len(g) == 33 and convs.train_macs_per_image(g) == 100_930_682_880
    # res4.1.conv2: 1024 channels in 32 groups at 46x80, stride 1.
    c = next(c for c in g if c.name == "res4.1.conv2")
    act = 16 * 46 * 80 * 1024 * 2
    w = 1024 * 32 * 9 * 2
    assert c.bytes(16) == (2 * act + w, 2 * act + w, 2 * act + w)
    # The stride in the 3x3: res3.0's conv1 at 184x320, its conv2 out at 92x160.
    first = {c.name: c for c in cs if c.name.startswith("res3.0.")}
    assert first["res3.0.conv1"].out_hw == (184, 320) and first["res3.0.conv2"].out_hw == (92, 160)
    # res2 is frozen: its grouped 3x3s run the forward alone.
    assert all(c.bytes(1)[1:] == (0, 0) for c in g if c.name.startswith("res2."))
    assert 1.9e9 < cres.grouped_train_bytes(cs, 1) < 2.0e9


def test_reference_at_r50_is_model_py():
    shapes = resnets.parameter_shapes(resnets.Backbone(), 7)
    assert list(shapes.items()) == list(model.parameter_shapes(7).items())
    sd = gen.weights(3, shapes, "init", "cpu")
    images = gen.canvases(5, 2, (64, 96), (60, 96), "cpu")
    ours = resnets.forward(sd, images, resnets.Backbone(), 4, 7)
    theirs = model.forward(sd, images, 4, 7)
    for k, v in theirs.items():
        assert torch.equal(ours[k], v), k


def _steps(chunk, r50=True, seed=11):
    arch = resnets.Backbone() if r50 else resnets.Backbone.of(MODEL)
    shapes = resnets.parameter_shapes(arch, 7)
    sd = gen.weights(seed, shapes, "init", "cpu")
    batches = gen.train_batches(seed + 7, 2, 4, (64, 96), (60, 96), "cpu", 12.3, 100,
                                [1, 1, 1, 1, 1, 1, 1])
    sv = rtrain.Solver(num_classes=7, base_lr=0.01, warmup_iters=0, dropout_rate=0.2,
                       cls_samples=10)
    return sd, batches, sv, resnets.run_steps(sd, batches, seed, 2, sv, (64, 96), arch,
                                              chunk=chunk)


def test_reference_steps_at_r50_are_train_py():
    sd, batches, sv, ours = _steps(None)
    theirs = rtrain.run_steps(sd, batches, 11, 2, sv, (64, 96))
    assert ours.losses == theirs.losses
    assert ours.grad_norms == theirs.grad_norms
    assert ours.update_norms == theirs.update_norms


def test_reference_steps_in_chunks_are_the_whole_batchs():
    _, _, _, whole = _steps(None, r50=False)
    _, _, _, chunked = _steps(1, r50=False)
    for a, b in zip(whole.losses, chunked.losses):
        for k in a:
            assert b[k] == pytest.approx(a[k], rel=1e-5), k
    for k, v in whole.grad_norms.items():
        assert chunked.grad_norms[k] == pytest.approx(v, rel=1e-4, abs=1e-9), k


def _run_cell(capsys, opts=(), seconds="1"):
    def tweak(cell):
        small(cell)
        cell.traffic["opts"] = list(cell.traffic["opts"]) + list(opts)

    rc = run.main(["--workload", CELL, "--seed", "2147484999", "--seconds", seconds,
                   "--trace", "0"], device="cpu", tweak=tweak)
    assert rc == 0
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1]), out


def test_cell_runs_and_is_correct_in_float32(capsys):
    result, lines = _run_cell(capsys, ["PARALLEL.COMPUTE_DTYPE", "float32"])
    checks = {k: v["value"] for k, v in result["checks"].items()}
    # 101 layers in channels-last against contiguous float32: the losses
    # and first gradients agree to ~1e-5, the three steps' changes to ~1e-3.
    assert checks["loss_gap"] < 1e-4 and checks["grad_gap"] < 1e-4
    assert checks["update_gap"] < 5e-3
    assert result["correct"]
    assert any("grouped 3x3 calls" in line and "(33.0 a step)" in line for line in lines)


def test_cell_fails_with_its_state_unchanged(capsys, monkeypatch):
    monkeypatch.setattr(torch.optim.SGD, "step", lambda self, closure=None: None)
    result, _ = _run_cell(capsys)
    assert not result["correct"]


def test_cell_controls():
    cell = bench.load_cell(CELL)
    small(cell)
    driver = bench.load_module("drivers", cell.traffic["driver"])
    state = driver.set_up(cell, 2147485001, torch.device("cpu"), Spans())
    sound = driver.check(state)
    full = state.program["readings"]
    as_program = lambda r: {"losses": r.losses, "grad_norms": r.grad_norms,
                            "update_norms": r.update_norms}
    fp8 = driver.compare(as_program(driver.reference(state, quant=model.fp8)), full)
    half = driver.compare(as_program(driver.reference(state, half_batch=True)), full)
    assert not any(v > cell.limits[k] for k, v in sound.items())
    assert fp8["grad_gap"] > sound["grad_gap"] and fp8["update_gap"] > sound["update_gap"]
    assert any(v > cell.limits[k] for k, v in half.items())
    assert calibrate.worst_leaves(driver, state.program, full)


def _record(**kw):
    rec = {"kind": "train", "cell": bench.load_cell(CELL), "setup_s": 40.0, "window_s": 10.0,
           "images": 320, "batch": 16, "step_ms": [], "peak_bytes": 2 ** 34, "trace": None,
           "host_trace": None}
    rec.update(kw)
    return rec


def read(name, rec):
    return bench.load_module("metrics", name).read(rec)


def test_mfu_resnext_reads_the_configurations_backbone():
    flops = 2.0 * 1_213_799_516_160
    assert read("mfu_resnext_pct.train", _record()) == pytest.approx(
        100 * flops * 32.0 / peaks.BF16_FLOPS)
    r50 = _record(cell=bench.load_cell("dropout_train_b4"), batch=4)
    assert read("mfu_resnext_pct.train", r50) == pytest.approx(read("mfu_pct.train", r50))
    assert read("mfu_resnext_pct.train", _record(kind="infer")) is None


@pytest.mark.parametrize("cell", ["dropout_train_b4", CELL])
def test_backbone_span_reader(cell):
    c = bench.load_cell(cell)
    steps = int(c.traffic["profile_steps"])
    spans = [(tr.WINDOW_SPAN, 0.0, 1e6)] + [("pod.backbone", 1000.0 + 5000.0 * i,
                                             1000.0 + 5000.0 * i + 3000.0) for i in range(steps)]
    rec = _record(cell=c, host_trace=tr.Trace(device=[], spans=spans, window=(0.0, 1e6)))
    assert read("backbone_ms.train", rec) == pytest.approx(3.0)
    assert "backbone_ms.train" in {m["name"] for m in c.per_layer}
    rec["host_trace"] = tr.Trace(device=[], spans=spans[:1], window=(0.0, 1e6))
    assert read("backbone_ms.train", rec) is None  # a program without the span


# Kernel names the card ran for X101's convolutions at batch 16 (bf16,
# channels-last; cuDNN 9.2, torch 2.11): the grouped 3x3s' own, and names
# that grouped and ungrouped convolutions share.
G2_FPROP = ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize64x64x64_"
            "warpgroupsize1x1x1_g2_execute_segment_k_off_kernel__5x_cudnn")
G2_DGRAD = ("sm90_xmma_dgrad_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize64x64x64_"
            "warpgroupsize1x1x1_g2_execute_segment_k_off_kernel__5x_cudnn")
SLICE = ("void nhwcSliceCKernel<__nv_bfloat16, __nv_bfloat16, float, true, "
         "(cudnnKernelDataType_t)0>(cudnn::reduced_divisor, int, int, int, __nv_bfloat16 const*, "
         "__nv_bfloat16*, float, float)")
SHARED_G1 = ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize64x64x64_"
             "warpgroupsize1x1x1_g1_execute_segment_k_off_kernel__5x_cudnn")
SHARED_CUTLASS = ("void cutlass__5x_cudnn::Kernel<cutlass_tensorop_bf16_s16816fprop_optimized_bf16_"
                  "256x64_32x4_nhwc_align8>(cutlass_tensorop_bf16_s16816fprop_optimized_bf16_"
                  "256x64_32x4_nhwc_align8::Params)")


def test_grouped_kernels_are_told_by_their_operator_not_their_name():
    driver = bench.load_module("drivers", "train_steps_resnet")
    ops = [
        ("aten::convolution", [[16, 1024, 46, 80], [1024, 32, 3, 3], []], [(G2_FPROP, 178.0)]),
        ("aten::convolution_backward", [[16, 1024, 46, 80], [16, 1024, 46, 80],
                                        [1024, 32, 3, 3]], [(G2_DGRAD, 153.0)]),
        ("aten::convolution", [[16, 512, 92, 160], [512, 16, 3, 3], []],
         [(SLICE, 1111.0), (SHARED_CUTLASS, 1363.0)]),
        ("aten::convolution", [[16, 2048, 23, 40], [2048, 64, 3, 3], []], [(SHARED_G1, 93.0)]),
        ("aten::convolution", [[16, 256, 46, 80], [1024, 256, 1, 1], []],
         [(SHARED_G1, 87.0), (SHARED_CUTLASS, 10.0)]),
        ("aten::convolution_backward", [[16, 256, 92, 160], [16, 256, 92, 160],
                                        [256, 256, 3, 3]], [(SHARED_G1, 40.0)]),
        ("aten::add", [[16, 256, 92, 160]], [(SHARED_G1, 5.0)]),
    ]
    got = driver.grouped_kernels(ops)
    assert got == pytest.approx({G2_FPROP: 178e-6, G2_DGRAD: 153e-6, SLICE: 1111e-6,
                                 SHARED_CUTLASS: 1363e-6, SHARED_G1: 93e-6})


def test_grouped_ops_of_a_step_on_the_cpu():
    from torch.profiler import ProfilerActivity, profile

    cell = bench.load_cell(CELL)
    small(cell)
    driver = bench.load_module("drivers", cell.traffic["driver"])
    state = driver.build(cell, 2147485003, torch.device("cpu"))
    try:
        with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
            driver.window(state, float("inf"), Spans(), 0, max_steps=1)
    finally:
        driver.free_program(state)
    ops = driver.conv_ops(prof.events())
    grouped = [op for op, shapes, _ in ops if driver.is_grouped(op, shapes)]
    # 33 grouped 3x3s forward; res3-res5's 30 backward (res2 is frozen).
    assert grouped.count("aten::convolution") == 33
    assert grouped.count("aten::convolution_backward") == 30
    assert driver.grouped_kernels(ops) == {}  # no device: no kernel to attribute


def test_gconv_roofline_reader():
    cs = cres.grouped(cres.model_convs((736, 1280), MODEL))
    flops = 2.0 * 16 * sum(c.macs * (1 + c.trainable + c.input_grad) for c in cs)
    least = max(cres.grouped_train_bytes(cs, 16) / peaks.HBM_BYTES_PER_S,
                flops / peaks.BF16_FLOPS)
    assert least == cres.grouped_train_bytes(cs, 16) / peaks.HBM_BYTES_PER_S  # bytes bound it
    steps = int(bench.load_cell(CELL).traffic["profile_steps"])
    rec = _record(gconv_kernels={G2_FPROP: 2 * steps * least, SLICE: 2 * steps * least})
    assert read("gconv_roofline_pct.train", rec) == pytest.approx(25.0)
    assert read("gconv_roofline_pct.train", _record()) is None
    assert read("gconv_roofline_pct.train", _record(gconv_kernels={})) is None
