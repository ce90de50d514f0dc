"""The readers of the port's own spans on a synthetic host trace."""

import pytest

from portbench.harness import bench, trace as tr

INFER = "dropout_bayes_od_mc_b8"
TRAIN = "dropout_train_b4"
SPAN_METRICS = {
    "core_ms.infer": "pod.core", "nms_ms.infer": "pod.nms", "fusion_ms.infer": "pod.fusion",
    "forward_ms.train": "pod.forward", "matcher_ms.train": "pod.matcher",
    "loss_ms.train": "pod.loss", "backward_ms.train": "pod.backward",
    "optimizer_ms.train": "pod.optimizer",
}


def _record(kind, spans, window=(0.0, 1e6), host=True):
    cell = bench.load_cell(INFER if kind == "infer" else TRAIN)
    trace = tr.Trace(device=[], spans=[(tr.WINDOW_SPAN, *window)] + list(spans), window=window)
    return {"kind": kind, "cell": cell, "trace": None, "host_trace": trace if host else None}


def read(name, rec):
    return bench.load_module("metrics", name).read(rec)


def _per_image(name, batches, images, us):
    """`batches` batches of `images` spans of `us` microseconds each, one
    after another from t = 1000."""
    out, t = [], 1000.0
    for _ in range(batches * images):
        out.append((name, t, t + us))
        t += us + 10.0
    return out


@pytest.mark.parametrize("metric", [m for m in SPAN_METRICS if m.endswith(".infer")])
def test_infer_span_sums_a_batchs_images_over_profile_batches(metric):
    rec = _record("infer", [])
    batches = int(rec["cell"].traffic["profile_batches"])
    rec["host_trace"].spans += _per_image(SPAN_METRICS[metric], batches, 8, 2500.0)
    rec["host_trace"].spans.append(("pod.detect", 1000.0, 9e5))
    assert read(metric, rec) == pytest.approx(8 * 2.5)


@pytest.mark.parametrize("metric", [m for m in SPAN_METRICS if m.endswith(".train")])
def test_train_span_over_profile_steps(metric):
    rec = _record("train", [])
    steps = int(rec["cell"].traffic["profile_steps"])
    rec["host_trace"].spans += _per_image(SPAN_METRICS[metric], steps, 1, 4000.0)
    rec["host_trace"].spans.append(("pod.step", 1000.0, 9e5))
    assert read(metric, rec) == pytest.approx(4.0)


def test_a_span_outside_the_window_is_ignored_and_one_across_its_edge_clipped():
    rec = _record("infer", [("pod.core", 0.0, 500.0), ("pod.core", 2e6, 3e6),
                            ("pod.core", 1000.0, 4000.0), ("pod.core", 9e5, 1.3e6)],
                  window=(1000.0, 1e6))
    batches = int(rec["cell"].traffic["profile_batches"])
    assert read("core_ms.infer", rec) == pytest.approx((3000.0 + 1e5) * 1e-3 / batches)


@pytest.mark.parametrize("metric", sorted(SPAN_METRICS))
def test_none_without_a_host_trace_the_span_or_the_kind(metric):
    kind = metric.rsplit(".", 1)[1]
    other = "train" if kind == "infer" else "infer"
    span = [(SPAN_METRICS[metric], 10.0, 20.0)]
    assert read(metric, _record(kind, span, host=False)) is None
    assert read(metric, _record(kind, [("pod.other", 10.0, 20.0)])) is None
    assert read(metric, _record(other, span)) is None
    assert read(metric, _record(kind, span)) is not None


def test_each_reader_is_in_the_cells_that_list_it():
    spec = bench.benchmark()
    entries = {m["name"]: m for m in spec["per_layer"] if m["name"] in SPAN_METRICS}
    assert set(entries) == set(SPAN_METRICS)
    for name, m in entries.items():
        assert m["source"] == "program_span" and m["unit"] == "ms"
        for cell in m["workloads"]:
            assert name in {p["name"] for p in bench.load_cell(cell).per_layer}
