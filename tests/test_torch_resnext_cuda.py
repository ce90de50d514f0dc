"""ResNeXt-101-32x8d-FPN's MC-dropout bank on a card, against the plain
reference ``tests/plain_resnext.py`` in float32.

It skips where there is no CUDA device. The file imports neither JAX nor
the JAX package, so on a machine with a card it runs without the suite's
conftest:

    python -m pytest --noconftest -p no:cacheprovider -q -s tests/test_torch_resnext_cuda.py

One batch of two 736x1280 canvases through ``ProbabilisticPredictor``
(the flagship's BayesOD MC-dropout config on the X101 backbone, bf16, the
dropout kernel drawing the ten runs' batch-shared masks from seeds) and
through the reference with the same masks (the port's plain dropout on the
reference's float32 activations, in the channels-last order the kernel
draws in). The gaps are the benchmark's inference check's: per image and
run, the largest |port - reference| over the reference's largest value,
of the class logits and log-variances (`logit_gap`) and of the deltas and
box variances (`delta_gap`). The limit, 0.05 on both, lies between what
bf16 gives through 101 layers (0.018-0.019 at 256x384 on the CPU, against
R50's 0.004-0.012 in the flagship cell, whose 0.035 and 0.014 it would
miss) and what the reference gives on its weights rounded to float8 e4m3
with a per-tensor scale (0.10-0.12), which the test holds above it. The
weights are ``plain_resnext.random_state``'s with each residual branch's
last FrozenBN at 0.25, the benchmark cell's scale.
"""

import numpy as np
import pytest
import torch

import plain_resnext as P
from pod_compare_tpu_torch.config import merge_configs
from pod_compare_tpu_torch.inference import build_predictor
from pod_compare_tpu_torch.inference.seeds import draw_seeds
from pod_compare_tpu_torch.models import level_offsets
from pod_compare_tpu_torch.ops.kernels import dropout as kd

TRAIN_CFG = "BDD-Detection/retinanet/retinanet_R_50_FPN_1x_reg_cls_var_dropout.yaml"
X101_OPTS = [
    "MODEL.RESNETS.DEPTH", 101,
    "MODEL.RESNETS.NUM_GROUPS", 32,
    "MODEL.RESNETS.WIDTH_PER_GROUP", 8,
    "MODEL.RESNETS.STRIDE_IN_1X1", False,
    "MODEL.PIXEL_STD", [57.375, 57.120, 58.395],
]
CANVAS = (736, 1280)
LIMITS = {"logit_gap": 0.05, "delta_gap": 0.05}
GAP_OF = {"box_cls": "logit_gap", "box_cls_var": "logit_gap", "box_delta": "delta_gap",
          "box_reg_var": "delta_gap"}


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


class _PlainMasks:
    """ReLU then the dropout kernel's batch-shared mask of (tower, layer),
    drawn by its plain version over the levels' channels-last order."""

    def __init__(self, seeds, rate, offsets):
        self.seeds, self.rate, self.offsets = seeds, rate, offsets

    def __call__(self, xs, tower, layer):
        seed = int(self.seeds[tower, layer])
        return [kd.dropout_plain(x.contiguous(memory_format=torch.channels_last), seed,
                                 self.rate, True, off, relu=True)
                for x, off in zip(xs, self.offsets)]


def test_x101_mc_dropout_bank_matches_the_reference():
    _cuda()
    cfg = merge_configs(TRAIN_CFG, "Inference/bayes_od_mc_dropout.yaml", X101_OPTS)
    num_convs, num_classes = cfg.MODEL.RETINANET.NUM_CONVS, cfg.MODEL.RETINANET.NUM_CLASSES
    runs, rate = cfg.PROBABILISTIC_INFERENCE.MC_DROPOUT.NUM_RUNS, \
        cfg.MODEL.PROBABILISTIC_MODELING.DROPOUT_RATE
    sd = P.random_state(P.parameter_shapes(P.X101_32X8D, num_classes), seed=19,
                        residual_scale=0.25)
    predictor = build_predictor(cfg, CANVAS, sd, device="cuda")
    rs = np.random.RandomState(0)
    images = torch.as_tensor((rs.rand(2, *CANVAS, 3) * 255).astype(np.uint8)).cuda()
    launches = kd.LAUNCHES
    outs = predictor.run_outputs(images, dropout_gen=torch.Generator().manual_seed(7))
    assert kd.LAUNCHES - launches == runs * 2 * num_convs
    seeds = draw_seeds(torch.Generator().manual_seed(7), (runs, 2, num_convs))

    P.strict_float32()
    ref_sd = {k: v.cuda() for k, v in sd.items()}
    fp8_sd = {k: _fp8(v) if v.dim() == 4 else v for k, v in ref_sd.items()}
    with torch.no_grad():
        want = _reference_runs(ref_sd, images, seeds, rate, num_convs, num_classes)
        gaps = _gaps([{k: v[m].float() for k, v in outs.items()} for m in range(runs)], want)
        control = _gaps(_reference_runs(fp8_sd, images, seeds, rate, num_convs, num_classes),
                        want)
    print("x101 mc bank on", torch.cuda.get_device_name(0), gaps, "float8 weights", control)
    for name, limit in LIMITS.items():
        assert gaps[name] < limit < control[name], (name, gaps[name], control[name])


def _fp8(w):
    """w rounded to float8 e4m3 under a per-tensor scale, in float32."""
    scale = 448.0 / w.abs().amax().clamp_min(1e-30)
    return (w * scale).to(torch.float8_e4m3fn).float() / scale


def _reference_runs(sd, images, seeds, rate, num_convs, num_classes):
    levels = P.fpn(sd, P.resnet(sd, P.normalize(images, P.X101_32X8D), P.X101_32X8D))
    offsets = level_offsets(levels, batch_shared=True)
    return [P.head(sd, levels, num_convs, num_classes, act=_PlainMasks(s, rate, offsets))
            for s in seeds]


def _gaps(runs, want):
    gaps = dict.fromkeys(LIMITS, 0.0)
    for got, ref in zip(runs, want):
        for key, r in ref.items():
            for b in range(r.shape[0]):
                gap = float((got[key][b] - r[b]).abs().max() / r[b].abs().max())
                gaps[GAP_OF[key]] = max(gaps[GAP_OF[key]], gap)
    return gaps
