"""The port's multi-process layer (``pod_compare_tpu_torch/parallel``) on the
CPU: process groups of two gloo processes spawned by ``parallel.launch``,
each on two torch threads (and OMP_NUM_THREADS=2), each launch joined with
its own timeout so that a hung rendezvous fails one test.

The JAX package runs one controller over a device mesh; the port runs one
process per card. So the counterparts of the JAX tests are at the process
level:

* ``tests/test_multihost.py::test_two_process_evaluation_matches_single_process``:
  its synthetic set (7 images, 64x80, 3 classes, seed 11), config and
  weights; ``run_inference`` on two processes, each on its strided shard,
  gathers a json that equals the port's one-process json and JAX's under
  that test's tolerances (image and class exact; score to 4 decimals and
  box to 2, within 0.05; mAP within 1e-4). The flagship (BayesOD +
  MC-dropout, three runs of the dropout kernel's plain version) on two
  processes equals one-process runs over each shard alone: rank r's k-th
  batch takes the k-th seed drawn from cfg.SEED, as in the JAX CLI, so a
  two-process MC json differs from a one-process json by design and is
  held to that law, not to equality.
* ``tests/test_sharded_inference.py::test_sharded_matches_single_device``
  (a one-process data mesh) has its counterpart in the two-process runs
  above: the port shards evaluation over processes, not over a mesh.
* ``tests/test_multihost.py::test_two_process_distributed_train_axis``: a
  data-parallel step of the flagship training config (R50 at 64x64, batch
  4, 2 per process, the focal kernel's and the dropout kernel's plain
  versions) through ``DistributedDataParallel`` equals the one-process step
  over the whole batch from the same state: losses within 1e-5 relative,
  every gradient and updated weight within 1e-5 of its tensor's largest
  magnitude (the sums run in another order; measured under 1e-6), at each
  of two steps, every process's weights bit-identical; once more with
  process 1's rows holding only images without ground truth, whose
  gradients must stay finite (ROADMAP §3, fault 1). Each step is compared
  from the state the processes hold before it: over several steps a weight
  one rounding apart flips a ReLU gate now and then (ROADMAP §3, fault 4),
  and one flip at P6's 1x1 level moved its gradient by 7% in a trial.
* ``tests/test_sharded_inference.py::test_ensemble_member_axis_sharding``:
  its inputs through the predictor with a member placement from
  ``create_ensemble_placement``, against the unplaced predictor (equal) and
  the JAX single-device ensemble (that test's tolerances).

Also here: the rank offsets of the dropout kernel's per-sample masks and the
focal kernel's ``index_base`` (on the plain versions, the draw of a slice
is the full draw's slice: the masks and the focal keys bit for bit, the
focal outputs within 1e-6 of scale; the 'threefry' focal bank's and the
energy score's shard losses summing to the whole batch's), the loaders' process
shards, ``apply_net.main`` spawning ``--num-devices 2`` processes, and the
refusals (an indivisible batch, more cards than there are, a failing rank).
"""

import functools
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.multiprocessing import ProcessRaisedException

import torch_parallel_workers as workers
from pod_compare_tpu.cli.apply_net import run_inference as jax_run_inference
from pod_compare_tpu.config import get_cfg as jax_get_cfg
from pod_compare_tpu.data.datasets import register_coco_instances as jax_register
from pod_compare_tpu.inference import build_predictor as jax_build_predictor
from pod_compare_tpu.models import build_model as jax_build_model
from pod_compare_tpu.models import init_model_params
from pod_compare_tpu_torch.cli import apply_net
from pod_compare_tpu_torch.config import get_cfg, merge_configs, setup_arg_parser
from pod_compare_tpu_torch.data import TestLoader, TrainLoader, get_dataset
from pod_compare_tpu_torch.data.synthetic import generate_synthetic_dataset
from pod_compare_tpu_torch.inference import build_predictor
from pod_compare_tpu_torch.models import build_model, level_offsets
from pod_compare_tpu_torch.models.convert import from_jax_params
from pod_compare_tpu_torch.ops.kernels import dropout as kd
from pod_compare_tpu_torch.ops.kernels import focal as kf
from pod_compare_tpu_torch.parallel import (
    BatchShard,
    check_process_count,
    create_ensemble_placement,
    gather_process_results,
    launch,
    resolve_num_devices,
)
from pod_compare_tpu_torch.train.checkpoint import Checkpointer
from test_torch_modes import few_threads  # noqa: F401  (module fixture)

NAME = "mh_synth"
LAUNCH_TIMEOUT_S = 300


@pytest.fixture(scope="module", autouse=True)
def child_threads():
    """Two OpenMP threads in every spawned process (read when it starts)."""
    before = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = str(workers.THREADS)
    yield
    if before is None:
        os.environ.pop("OMP_NUM_THREADS")
    else:
        os.environ["OMP_NUM_THREADS"] = before


def _launch(fn, *args):
    return launch(fn, 2, args, device="cpu", timeout_s=LAUNCH_TIMEOUT_S)


def _key(results):
    """tests/test_multihost.py's comparison key of a results json."""
    return sorted([r["image_id"], r["category_id"], round(r["score"], 4)]
                  + [round(x, 2) for x in r["bbox"]] for r in results)


def _assert_keys_close(got, want):
    assert len(got) == len(want), (len(got), len(want))
    for g, w in zip(got, want):
        assert g[:2] == w[:2], (g, w)
        np.testing.assert_allclose(g[2:], w[2:], atol=0.05)


def _json(summary_dir):
    with open(os.path.join(summary_dir, "coco_instances_results.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def evaluation(tmp_path_factory):
    """The synthetic set, the weights, the two-process runs and the
    one-process references, port and JAX."""
    root = tmp_path_factory.mktemp("parallel_eval")
    json_file, image_dir = generate_synthetic_dataset(
        str(root), NAME, num_images=7, image_size=(64, 80), num_classes=3, seed=11)
    workers.register(NAME, json_file, image_dir)
    jax_register(NAME, json_file, image_dir, [f"class_{i}" for i in range(3)],
                 {i + 1: i for i in range(3)})
    jcfg = jax_get_cfg()
    jcfg.merge_from_list(workers.MULTIHOST_OPTS + [
        "DATASETS.TRAIN", (NAME,), "DATASETS.TEST", (NAME,),
        "OUTPUT_DIR", str(root / "jax")])
    params = init_model_params(jax_build_model(jcfg), (64, 96), seed=0)
    state_dict = from_jax_params(jax.tree_util.tree_map(np.asarray, params))
    weights = str(root / "weights.pt")
    torch.save(state_dict, weights)

    two = _launch(workers.evaluate, (NAME, json_file, image_dir), weights, str(root / "two"))
    jax_summary = jax_run_inference(jcfg, NAME, "mh_eval", batch_size=2, params=params,
                                    run_metrics=False, run_map=True, verbose=False)
    one = {}
    for mode in ("standard_nms", "flagship"):
        cfg = workers.eval_cfg(mode, NAME, str(root / "one" / mode))
        one[mode] = apply_net.run_inference(cfg, NAME, mode, batch_size=2, params=state_dict,
                                            run_metrics=False, run_map=True, verbose=False,
                                            device="cpu")
    shards = []
    for r in range(2):
        cfg = workers.eval_cfg("flagship", NAME, str(root / f"shard{r}"))
        loader = TestLoader(get_dataset(NAME), batch_size=2, min_size=64, max_size=1333,
                            num_workers=1, process_index=r, process_count=2)
        shards.append(apply_net.run_inference(
            cfg, NAME, "flagship", batch_size=2, params=state_dict, run_metrics=False,
            run_map=False, verbose=False, device="cpu", loader=loader))
        loader.close()
    yield dict(two=two, jax=jax_summary, one=one, shards=shards, state_dict=state_dict,
               weights=weights, dataset=(json_file, image_dir), root=root)
    shutil.rmtree(root, ignore_errors=True)


def test_gather_process_results_concatenates_in_rank_order(evaluation):
    two = evaluation["two"]
    assert two["count"] == 2
    assert two["gathered"] == [{"rank": r, "item": i} for r in range(2) for i in range(r + 2)]
    assert gather_process_results([1, 2]) == [1, 2]  # no process group: the list itself


def test_two_process_standard_nms_matches_one_process_and_jax(evaluation):
    main, other = evaluation["two"]["standard_nms"]["summaries"]
    got = _key(_json(main["inference_output_dir"]))
    assert got, "no detections"
    _assert_keys_close(got, _key(_json(evaluation["one"]["standard_nms"]["inference_output_dir"])))
    _assert_keys_close(got, _key(_json(evaluation["jax"]["inference_output_dir"])))
    assert main["num_images"] == 7 == evaluation["jax"]["num_images"]
    np.testing.assert_allclose(main["mAP"], evaluation["jax"]["mAP"], atol=1e-4)
    np.testing.assert_allclose(main["mAP"], evaluation["one"]["standard_nms"]["mAP"], atol=1e-4)


def test_a_rank_other_than_0_returns_after_the_gathers(evaluation):
    """Rank 1's summary: the global image count, its own rate, no metric,
    and rank 0 alone wrote the json."""
    main, other = evaluation["two"]["standard_nms"]["summaries"]
    assert set(other) == {"num_images", "images_per_second", "inference_output_dir",
                          "is_main_process"}
    assert other["is_main_process"] is False and other["num_images"] == 7
    assert other["images_per_second"] > 0 and "mAP" not in other
    assert "is_main_process" not in main and main["num_detections"] > 0
    assert main["processes"] == 2 and main["gather_seconds"] >= 0


def test_flagship_on_two_processes_equals_its_shards_run_alone(evaluation):
    """The merged json is rank 0's shard, then rank 1's, each equal to a
    one-process run over that shard alone (same seeds in the same order)."""
    main, _ = evaluation["two"]["flagship"]["summaries"]
    merged = _json(main["inference_output_dir"])
    parts = [_json(s["inference_output_dir"]) for s in evaluation["shards"]]
    assert [r["image_id"] for r in merged] == [r["image_id"] for p in parts for r in p]
    assert {r["image_id"] for r in parts[0]} <= {0, 2, 4, 6}
    assert {r["image_id"] for r in parts[1]} <= {1, 3, 5}
    for got, want in zip(merged, [r for p in parts for r in p]):
        assert got["category_id"] == want["category_id"]
        for field in ("score", "bbox", "cls_prob", "bbox_covar"):
            np.testing.assert_allclose(got[field], want[field], rtol=1e-5, atol=1e-6,
                                       err_msg=field)
    assert main["num_images"] == 7 and len(merged) > 0


def test_main_spawns_num_devices_processes(evaluation, tmp_path, monkeypatch):
    """``apply_net.main`` with ``--num-devices 2 --device cpu`` launches two
    processes (which register BDD's layout from --dataset-dir themselves)
    and returns rank 0's summary, its json that of one process."""
    root = tmp_path / "bdd"
    json_file, image_dir = generate_synthetic_dataset(
        str(root), "val", num_images=5, image_size=(64, 80), num_classes=7, seed=4)
    os.makedirs(root / "labels")
    os.makedirs(root / "images" / "100k")
    os.replace(json_file, root / "labels" / "val_coco_format.json")
    os.replace(image_dir, root / "images" / "100k" / "val")
    monkeypatch.setenv("POD_COMPARE_DATA_DIR", str(tmp_path / "data"))
    monkeypatch.setattr(apply_net, "launch", functools.partial(launch, timeout_s=LAUNCH_TIMEOUT_S))
    train, infer = "BDD-Detection/retinanet/retinanet_R_50_FPN_1x_reg_cls_var.yaml", \
        "Inference/standard_nms.yaml"
    model = build_model(merge_configs(train, infer)).init_weights(torch.Generator().manual_seed(0))
    out = tmp_path / "data" / "BDD-Detection" / "retinanet" / "retinanet_R_50_FPN_1x_reg_cls_var"
    Checkpointer(str(out / "random_seed_0")).save(0, {"model": model.state_dict()})
    summaries = {}
    for n in (2, 1):
        args = setup_arg_parser().parse_args([
            "--config-file", train, "--inference-config", infer, "--dataset-dir", str(root),
            "--test-dataset", "bdd_val", "--num-devices", str(n),
            "MODEL.RETINANET.SCORE_THRESH_TEST", "0.0", "INPUT.MIN_SIZE_TEST", "64",
            "PARALLEL.COMPUTE_DTYPE", "float32", "DATALOADER.NUM_WORKERS", "1"])
        summaries[n] = apply_net.main(args, batch_size=2, device="cpu")
        summaries[n]["json"] = _key(_json(summaries[n]["inference_output_dir"]))
    assert summaries[2]["num_images"] == summaries[1]["num_images"] == 5
    assert summaries[2]["json"], "no detections"
    _assert_keys_close(summaries[2]["json"], summaries[1]["json"])


def _train_batch(rng, empty_rank_one: bool):
    b, size, g = 4, (64, 64), 5
    images = (rng.rand(b, *size, 3) * 255).astype(np.uint8)
    wh = rng.uniform(10, 40, (b, g, 2))
    xy = rng.uniform(0, 1, (b, g, 2)) * (np.array(size[::-1]) - wh)
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    classes = rng.randint(0, workers.NUM_CLASSES, (b, g)).astype(np.int64)
    valid = np.ones((b, g), bool)
    valid[1, 3:] = False
    if empty_rank_one:
        valid[2:] = False
    boxes[~valid] = 0.0
    return {"images": images, "gt_boxes": boxes, "gt_classes": classes, "gt_valid": valid}


@pytest.fixture(scope="module")
def ddp():
    rng = np.random.RandomState(21)
    batches = [_train_batch(rng, False), _train_batch(rng, True)]
    return _launch(workers.train_steps, batches, 2)


@pytest.mark.parametrize("case", ["mixed", "rank 1 without ground truth"])
def test_data_parallel_steps_equal_the_one_process_step(ddp, case):
    records = ddp[["mixed", "rank 1 without ground truth"].index(case)]
    for k, record in enumerate(records):
        for key in ("loss_cls", "loss_box_reg", "total_loss", "num_pos_anchors"):
            np.testing.assert_allclose(record["losses"][key], record["reference_losses"][key],
                                       rtol=1e-5, err_msg=f"step {k} {key}")
        assert record["grad_names"], "the trainable set differs"
        worst = max(record["grad_errors"].items(), key=lambda kv: kv[1])
        assert worst[1] <= 1e-5, f"step {k}: gradient {worst}"
        worst = max(record["weight_errors"].items(), key=lambda kv: kv[1])
        assert worst[1] <= 1e-5, f"step {k}: weight {worst}"


def test_data_parallel_weights_stay_identical_across_ranks(ddp):
    for records in ddp:
        for record in records:
            assert len(record["digests"]) == 2 and record["digests"][0] == record["digests"][1]


def test_a_rank_holding_only_images_without_ground_truth_keeps_finite_gradients(ddp):
    for record in ddp[1]:
        assert record["finite"]
        assert record["reference_losses"]["num_pos_anchors"] > 0  # rank 0's rows match


def _features(rng, batch):
    return [torch.from_numpy(rng.randn(batch, 8, h, w).astype(np.float32)).contiguous(
        memory_format=torch.channels_last) for h, w in ((8, 8), (4, 4), (2, 2))]


@pytest.mark.parametrize("count", [2, 4])
def test_dropout_masks_of_a_shard_are_the_global_batch_rows(count):
    """Per-sample K1 masks (plain version) of each process's rows, at the
    offsets ``level_offsets`` gives its shard, equal those rows of the
    one-process draw over the global batch, bit for bit."""
    feats = _features(np.random.RandomState(count), 4)
    full = [kd.dropout_plain(f, 77, 0.2, False, o, True)
            for f, o in zip(feats, level_offsets(feats, False))]
    for r in range(count):
        shard = BatchShard.of(4, r, count)
        rows = slice(shard.first, shard.first + shard.size)
        local = [f[rows] for f in feats]
        for f, o, want in zip(local, level_offsets(local, False, shard), full):
            assert torch.equal(kd.dropout_plain(f, 77, 0.2, False, o, True), want[rows])
    assert level_offsets(feats, True, BatchShard.of(4, 1, 2)) == level_offsets(feats, True)


@pytest.mark.parametrize("first", [1, 3])
def test_focal_draws_of_a_shard_are_the_global_batch_elements(first):
    """K2's plain version on rows [first:] with ``index_base`` at their
    first element draws the full draw's keys there, bit for bit, across the
    65536-element blocks of the key, and gives the full draw's rows within
    1e-6 of each plane's scale: PyTorch's CPU vector math rounds a few
    elements by one ulp when a tensor's length moves them to the scalar
    tail of its loops (5 of 153,000 at first = 1). The kernel, one element
    a thread, is held bit for bit on the card
    (``tests/test_torch_focal_cuda.py``)."""
    rng = np.random.RandomState(first)
    shape = (4, 17000, 3)
    x, s = (torch.from_numpy(rng.randn(*shape).astype(np.float32) * c) for c in (2.0, 3.0))
    t = torch.from_numpy((rng.rand(*shape) < 0.2).astype(np.float32))
    base = first * x[0].numel()
    assert torch.equal(kf.stream_keys(x[first:].numel(), -5, index_base=base),
                       kf.stream_keys(x.numel(), -5)[base:])
    full = kf.focal_plain(x, s, t, -5, 10)
    part = kf.focal_plain(x[first:], s[first:], t[first:], -5, 10, index_base=base)
    for a, b in zip(part, full):
        assert float((a - b[first:]).abs().max()) <= 1e-6 * float(b.abs().max())
    assert all(torch.equal(a, b) for a, b in zip(
        kf.focal_plain(x, s, t, -5, 10, index_base=0), full))
    with pytest.raises(ValueError, match="index base"):
        kf.focal_plain(x, s, t, -5, 10, index_base=-4)


def test_train_loader_shards_make_up_the_one_process_batch(evaluation):
    dataset = get_dataset(NAME)
    kw = dict(batch_size=4, min_size=(64,), max_size=1333, seed=3, num_workers=1, flip=True)
    one = TrainLoader(dataset, **kw)
    parts = [TrainLoader(dataset, process_index=r, process_count=2, **kw) for r in range(2)]
    try:
        whole = iter(one)
        shards = [p.iter_from(0) for p in parts]
        for _ in range(3):
            want = next(whole)
            got = [next(s) for s in shards]
            for key, value in want.items():
                np.testing.assert_array_equal(np.concatenate([g[key] for g in got]), value)
        np.testing.assert_array_equal(next(parts[1].iter_from(2))["images"],
                                      np.asarray(next(TrainLoader(
                                          dataset, process_index=1, process_count=2,
                                          **kw).iter_from(2))["images"]))
    finally:
        for loader in [one] + parts:
            loader.close()
    with pytest.raises(ValueError, match="does not divide"):
        TrainLoader(dataset, process_index=0, process_count=3, **kw)


def test_test_loader_shards_stride_the_records_on_the_whole_canvas(evaluation):
    dataset = get_dataset(NAME)
    whole = TestLoader(dataset, batch_size=2, min_size=64, max_size=1333, num_workers=1)
    parts = [TestLoader(dataset, batch_size=2, min_size=64, max_size=1333, num_workers=1,
                        process_index=r, process_count=3) for r in range(3)]
    assert all(p.canvas == whole.canvas for p in parts)
    assert [[r["image_id"] for r in p.records] for p in parts] == [[0, 3, 6], [1, 4], [2, 5]]
    for loader in [whole] + parts:
        loader.close()


def test_refusals():
    with pytest.raises(ValueError, match="does not divide"):
        BatchShard.of(5, 0, 2)
    assert BatchShard.of(4, 1, 2) == BatchShard(2, 2, 4)
    with pytest.raises(ValueError, match="asks for 3 processes, but this run has 1"):
        check_process_count(3)
    check_process_count(-1)
    check_process_count(1)
    assert resolve_num_devices(-1, "cpu") == 1 and resolve_num_devices(3, "cpu") == 3
    with pytest.raises(ValueError, match="-1"):
        resolve_num_devices(0, "cpu")


def test_more_cards_than_there_are_raises_naming_both(monkeypatch, tmp_path):
    """``--num-devices 2`` on a one-card machine, before anything starts."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match=r"asks for 2 CUDA devices, but "
                                         r"torch.cuda.device_count\(\) is 1"):
        resolve_num_devices(2)
    monkeypatch.setenv("POD_COMPARE_DATA_DIR", str(tmp_path))
    args = setup_arg_parser().parse_args(
        ["--config-file", "BDD-Detection/retinanet/retinanet_R_50_FPN_1x_reg_cls_var.yaml",
         "--inference-config", "Inference/standard_nms.yaml", "--num-devices", "2"])
    with pytest.raises(ValueError, match="asks for 2 CUDA devices"):
        apply_net.main(args)
    assert resolve_num_devices(2, "cuda:0") == 2  # processes pinned to one card share it


def test_launch_raises_the_failing_rank_s_error():
    with pytest.raises(ProcessRaisedException,
                       match="Process 1 terminated(.|\n)*rank 1 fails on purpose"):
        _launch(workers.fail_on_rank_one)


def test_launch_kills_processes_that_outlive_its_timeout():
    with pytest.raises(TimeoutError, match="still running"):
        launch(workers.sleep_forever, 2, (), device="cpu", timeout_s=5)


def _jax_ensemble_inputs():
    """tests/test_sharded_inference.py's ensemble test: 5 classes, two
    members from seeds 0 and 1, batch 4 at 32x32."""
    from test_sharded_inference import IMAGE_SIZE, make_cfg

    jcfg = make_cfg()
    jcfg.PROBABILISTIC_INFERENCE.INFERENCE_MODE = "ensembles"
    jcfg.PROBABILISTIC_INFERENCE.ENSEMBLES.BOX_MERGE_MODE = "pre_nms"
    jcfg.PROBABILISTIC_INFERENCE.ENSEMBLES.RANDOM_SEED_NUMS = [0, 1000]
    model = jax_build_model(jcfg)
    params_list = [init_model_params(model, IMAGE_SIZE, seed=s) for s in [0, 1]]
    images = (np.random.RandomState(0).rand(4, *IMAGE_SIZE, 3) * 255).astype(np.float32)
    sizes = np.tile(np.asarray(IMAGE_SIZE, np.float32), (4, 1))
    return jcfg, params_list, images, sizes, IMAGE_SIZE


def test_ensemble_member_placement_matches_the_unplaced_predictor_and_jax():
    jcfg, params_list, images, sizes, size = _jax_ensemble_inputs()
    want = jax_build_predictor(jcfg, size, params_list=params_list)(
        jnp.asarray(images), sizes, sizes, jax.random.PRNGKey(0))
    cfg = get_cfg()
    cfg.merge_from_list([
        "MODEL.RETINANET.NUM_CLASSES", 5,
        "MODEL.PROBABILISTIC_MODELING.CLS_VAR_LOSS.NAME", "loss_attenuation",
        "MODEL.PROBABILISTIC_MODELING.CLS_VAR_LOSS.NUM_SAMPLES", 2,
        "MODEL.PROBABILISTIC_MODELING.BBOX_COV_LOSS.NAME", "negative_log_likelihood",
        "MODEL.PROBABILISTIC_MODELING.BBOX_COV_LOSS.NUM_SAMPLES", 20,
        "MODEL.RETINANET.TOPK_CANDIDATES_TEST", 32,
        "TEST.DETECTIONS_PER_IMAGE", 10,
        "PARALLEL.COMPUTE_DTYPE", "float32",
        "PROBABILISTIC_INFERENCE.INFERENCE_MODE", "ensembles",
        "PROBABILISTIC_INFERENCE.ENSEMBLES.BOX_MERGE_MODE", "pre_nms",
        "PROBABILISTIC_INFERENCE.ENSEMBLES.RANDOM_SEED_NUMS", [0, 1000],
    ])
    members = [from_jax_params(jax.tree_util.tree_map(np.asarray, p)) for p in params_list]
    placement = create_ensemble_placement(2, ["cpu"])
    assert placement == [torch.device("cpu")] * 2
    outs = []
    for where in (placement, None):
        predictor = build_predictor(cfg, size, device="cpu", state_dicts=members,
                                    placement=where)
        outs.append(predictor(images, sizes, sizes, generator=torch.Generator().manual_seed(0)))
    placed, unplaced = outs
    for a, b in zip(placed, unplaced):
        assert (a is None and b is None) or torch.equal(a, b)
    v = np.asarray(want.valid)
    np.testing.assert_array_equal(placed.valid.numpy(), v)
    assert v.any()
    np.testing.assert_allclose(placed.boxes.numpy()[v], np.asarray(want.boxes)[v], atol=5e-3)
    np.testing.assert_allclose(placed.scores.numpy()[v], np.asarray(want.scores)[v], atol=1e-4)
    with pytest.raises(ValueError, match="placement of 3 devices for 2"):
        build_predictor(cfg, size, device="cpu", state_dicts=members,
                        placement=create_ensemble_placement(3, ["cpu"]))
    assert create_ensemble_placement(5, ["cuda:0", "cuda:1"]) == [
        torch.device(f"cuda:{m % 2}") for m in range(5)]


@pytest.mark.parametrize("loss", ["threefry focal", "energy score"])
def test_sampled_losses_of_the_shards_sum_to_the_whole_batch(loss):
    """The 'threefry' focal bank and the energy score's normals, drawn for
    the global batch and cut to a shard's rows: the shards' losses sum to
    the one-process loss (within float32 summation order)."""
    from pod_compare_tpu_torch.ops import losses

    rng = np.random.RandomState(8)
    b, r = 4, 300
    t = lambda *shape, c=1.0: torch.from_numpy((rng.randn(*shape) * c).astype(np.float32))
    if loss == "threefry focal":
        x, s = t(b, r, 3, c=2.0), t(b, r, 3)
        y = torch.from_numpy((rng.rand(b, r, 3) < 0.2).astype(np.float32))
        valid = torch.from_numpy(rng.rand(b, r) < 0.9)
        fn = lambda rows, shard: losses.stochastic_focal_loss(
            x[rows], s[rows], y[rows], valid[rows], 10, 99, shard=shard)
    else:
        mu, gt, cov = t(b, r, 4), t(b, r, 4), t(b, r, 4, c=0.5)
        pos = torch.from_numpy(rng.rand(b, r) < 0.3)
        fn = lambda rows, shard: losses.energy_score_box_loss(
            mu[rows], gt[rows], cov[rows], pos[rows], 100, chunk=20,
            generator=torch.Generator().manual_seed(5), shard=shard)
    whole = float(fn(slice(0, b), None))
    parts = sum(float(fn(slice(sh.first, sh.first + sh.size), sh))
                for sh in (BatchShard.of(b, i, 2) for i in range(2)))
    np.testing.assert_allclose(parts, whole, rtol=1e-5)
    unsharded = sum(float(fn(slice(2 * i, 2 * i + 2), None)) for i in range(2))
    assert abs(unsharded - whole) > 1e-3 * abs(whole), "the draw of a slice alone is another"
