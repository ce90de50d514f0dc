"""PARALLEL.REMAT in the port's train step: the forward under
``torch.utils.checkpoint``, recomputed in the backward.

One step from the same state, seeds and batch with REMAT and without, on
the CPU (full R50 depth at 64x64, 3 classes, batch 2, float32): the losses,
every gradient tensor and every updated parameter equal bit for bit. On the
flagship training config the recomputed forward replays the dropout masks
(the plain version of the dropout kernel, its seeds drawn before the
forward) and the focal loss runs its plain K2; on the energy config the
energy score draws from its own generator, outside the recomputed region.
"""

import pytest
import torch

from pod_compare_tpu_torch.config import merge_configs
from pod_compare_tpu_torch.models import ProbabilisticRetinaNet, build_anchor_generator
from pod_compare_tpu_torch.train import RandomBatches, create_train_state, make_train_step
from pod_compare_tpu_torch.train.trainer import batch_to_device
from test_torch_modes import few_threads  # noqa: F401  (autouse: two torch threads)

CONFIGS = {
    "flagship": "BDD-Detection/retinanet/retinanet_R_50_FPN_1x_reg_cls_var_dropout.yaml",
    "energy": "BDD-Detection/retinanet/retinanet_R_50_FPN_1x_reg_covar_energy.yaml",
}
IMAGE_SIZE = (64, 64)
OVERRIDES = [
    "MODEL.RETINANET.NUM_CLASSES", 3,
    "PARALLEL.COMPUTE_DTYPE", "float32",
    "MODEL.PROBABILISTIC_MODELING.CLS_VAR_LOSS.IMPL", "pallas",
    "MODEL.PROBABILISTIC_MODELING.ANNEALING_STEP", 2,
    "SOLVER.IMS_PER_BATCH", 2,
]


def _step(name, remat, forwards=None):
    cfg = merge_configs(CONFIGS[name], "", OVERRIDES + ["PARALLEL.REMAT", remat])
    state = create_train_state(cfg, "cpu", seed=0)
    state.step = 1  # annealing weight 0.09: the probabilistic box loss counts
    anchors = torch.as_tensor(build_anchor_generator(cfg).concatenated(IMAGE_SIZE))
    step = make_train_step(cfg, anchors)
    assert step.remat == remat
    batch = next(RandomBatches(IMAGE_SIZE, 2, 3, max_gt_boxes=6, seed=11).iter_from(0))
    metrics = step(state, batch_to_device(batch, "cpu"))
    grads = {n: p.grad for n, p in state.model.named_parameters() if p.grad is not None}
    return metrics, grads, state.model.state_dict()


@pytest.mark.parametrize("name", list(CONFIGS))
def test_remat_step_equals_the_plain_step_bit_for_bit(name):
    plain, remat = _step(name, False), _step(name, True)
    for k, v in plain[0].items():
        assert torch.equal(v, remat[0][k]), k
        assert torch.isfinite(v).all(), k
    assert plain[1].keys() == remat[1].keys()
    assert any(n.startswith("head.bbox_cov") for n in plain[1])
    for n, g in plain[1].items():
        assert torch.equal(g, remat[1][n]), n
        assert torch.isfinite(g).all(), n
    for n, p in plain[2].items():
        assert torch.equal(p, remat[2][n]), n
    assert any(n.startswith("backbone.bottom_up.res5") for n in plain[1])


def test_remat_recomputes_the_forward_in_the_backward(monkeypatch):
    """With REMAT the model's forward runs twice a step (forward, then the
    recomputation in the backward), without it once."""
    calls = []
    real = ProbabilisticRetinaNet.forward_train

    def counted(self, *args, **kwargs):
        calls.append(1)
        return real(self, *args, **kwargs)

    monkeypatch.setattr(ProbabilisticRetinaNet, "forward_train", counted)
    _step("flagship", False)
    assert len(calls) == 1
    calls.clear()
    _step("flagship", True)
    assert len(calls) == 2
