"""Each metric reader on a synthetic record and trace."""

import pytest

from portbench.counts import kernels, peaks
from portbench.harness import bench, readers, trace as tr

K1_FWD = "void (anonymous namespace)::dropout_levels_kernel<__nv_bfloat16, false, 4>(x)"
K1_BWD = "void (anonymous namespace)::dropout_levels_kernel<__nv_bfloat16, true, 4>(x)"
K1_FWD_MANGLED = "_ZN12_GLOBAL__N_121dropout_levels_kernelI13__nv_bfloat16Lb0ELi4EEEvNS_6LevelsIT_EE"
K2 = "void (anonymous namespace)::focal_kernel<10, true, true>(float const*)"


def _trace(device, spans=(), window=(0.0, 1000.0)):
    return tr.Trace(device=list(device), spans=list(spans), window=window)


def _record(kind, cell_name, **kw):
    cell = bench.load_cell(cell_name)
    rec = {"kind": kind, "cell": cell, "setup_s": 31.5, "window_s": 10.0, "images": 240,
           "batch": 8 if kind == "infer" else 4, "num_runs": 10, "batch_ms": [],
           "step_ms": [], "peak_bytes": 3 * 2 ** 30, "trace": None, "stage_ms": {}}
    rec.update(kw)
    return rec


def read(name, rec):
    return bench.load_module("metrics", name).read(rec)


def test_union_counts_overlap_once():
    t = _trace([("a", 0.0, 100.0), ("b", 50.0, 150.0), ("c", 400.0, 500.0),
                ("d", 950.0, 1200.0)])
    assert tr.busy_s(t) == pytest.approx(300e-6)
    assert tr.idle_gaps(t) == [(150.0, 400.0), (500.0, 950.0)]


def test_idle_by_innermost_span_and_top_ops():
    t = _trace([("k1", 0.0, 100.0), ("k2", 300.0, 400.0), ("k1", 400.0, 500.0),
                ("k2", 600.0, 700.0)],
               spans=[(tr.WINDOW_SPAN, 0.0, 1000.0), ("train_step", 0.0, 650.0),
                      ("inner", 100.0, 300.0)])
    idle = dict(tr.idle_by_span(t))
    assert idle["inner"] == pytest.approx(200e-6)
    assert idle["train_step"] == pytest.approx(100e-6)
    assert idle["outside spans"] == pytest.approx(300e-6)
    ops = tr.top_device_ops(t)
    assert ops[0] == ["k1", pytest.approx(200e-6)]


def test_chrome_trace_parse():
    events = [{"ph": "X", "cat": "kernel", "name": "k", "ts": 10, "dur": 5},
              {"ph": "X", "cat": "user_annotation", "name": tr.WINDOW_SPAN, "ts": 0, "dur": 100},
              {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 0, "dur": 1},
              {"ph": "i", "cat": "kernel", "name": "x", "ts": 3}]
    t = tr.parse_chrome_trace(events)
    assert t.device == [("k", 10.0, 15.0)] and t.window == (0.0, 100.0)


def test_k1_direction():
    assert readers.k1_direction(K1_FWD) == "forward"
    assert readers.k1_direction(K1_BWD) == "backward"
    assert readers.k1_direction(K1_FWD_MANGLED) == "forward"
    assert readers.k1_direction(K2) is None


def test_end_to_end_readers():
    rec = _record("infer", "dropout_bayes_od_mc_b8")
    assert read("infer_img_per_s", rec) == pytest.approx(24.0)
    assert read("train_img_per_s", rec) is None
    assert read("peak_mem_gib", rec) == pytest.approx(3.0)
    assert read("setup_s", rec) == 31.5
    rec = _record("train", "dropout_train_b4", images=600)
    assert read("train_img_per_s", rec) == pytest.approx(60.0)


def test_quantile_readers():
    rec = _record("infer", "dropout_bayes_od_mc_b8", batch_ms=[float(i) for i in range(1, 101)])
    assert read("batch_ms_p90.infer", rec) == pytest.approx(90.9)
    rec = _record("train", "dropout_train_b4", step_ms=[float(i) for i in range(1, 101)])
    assert read("step_ms_p95.train", rec) == pytest.approx(95.95)
    assert read("step_ms_p95.train", _record("train", "dropout_train_b4")) is None


def test_stage_readers():
    rec = _record("infer", "dropout_bayes_od_mc_b8",
                  stage_ms={"head_outputs": [60.0, 70.0], "detect": [200.0]})
    assert read("head_bank_ms.infer", rec) == pytest.approx(65.0)
    assert read("detect_ms.infer", rec) == pytest.approx(200.0)
    assert read("head_bank_ms.infer", _record("infer", "dropout_bayes_od_mc_b8")) is None


def test_k1_rooflines():
    bound_us = kernels.k1_forward_bound_s(kernels.k1_bytes(8, 19620)) * 1e6
    t = _trace([(K1_FWD, 0.0, 2 * bound_us), (K1_FWD, 500.0, 500.0 + 2 * bound_us)])
    rec = _record("infer", "dropout_bayes_od_mc_b8", trace=t)
    assert read("k1_fwd_roofline_pct.infer", rec) == pytest.approx(50.0)
    assert read("k1_fwd_roofline_pct.infer", _record("infer", "dropout_bayes_od_mc_b8",
                                                     trace=_trace([]))) is None
    x = kernels.k1_bytes(4, 19620)
    fwd, bwd = kernels.k1_forward_bound_s(x) * 1e6, kernels.k1_backward_bound_s(x) * 1e6
    t = _trace([(K1_FWD, 0.0, fwd), (K1_BWD, 100.0, 100.0 + 3 * bwd)])
    rec = _record("train", "dropout_train_b4", trace=t)
    assert read("k1_roofline_pct.train", rec) == pytest.approx(100.0 * (fwd + bwd) / (fwd + 3 * bwd))


def test_k2_roofline():
    bound_us = kernels.k2_bound_s(4 * 176580 * 7, 10) * 1e6
    t = _trace([(K2, 0.0, 4 * bound_us)])
    assert read("k2_roofline_pct.train", _record("train", "dropout_train_b4", trace=t)) == \
        pytest.approx(25.0)


def test_mfu_and_idle():
    rec = _record("infer", "dropout_bayes_od_mc_b8",
                  trace=_trace([("k", 0.0, 250.0)], window=(0.0, 1000.0)))
    flops = readers.flops_per_image(rec)
    assert read("mfu_pct.infer", rec) == pytest.approx(100 * flops * 24.0 / peaks.BF16_FLOPS)
    assert read("device_idle_pct.infer", rec) == pytest.approx(75.0)
    assert read("device_idle_pct.train", rec) is None
    assert read("mfu_pct.train", rec) is None
