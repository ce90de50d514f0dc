"""The plain reference against the port, at a small size on the CPU.

With the port computing in float32 (PARALLEL.COMPUTE_DTYPE float32), a
whole run of each cell's harness must find the port and the reference
agreeing to float32 rounding: the head outputs with the same dropout masks,
the core and mode, and three training steps. The frozen bits are held
against the port's plain versions directly.
"""

import json

import pytest
import torch

from conftest import small
from portbench import run
from portbench.reference import bits, train as rtrain


def run_cell(capsys, workload, opts=(), seconds="4"):
    def tweak(cell):
        small(cell)
        cell.traffic["opts"] = list(cell.traffic["opts"]) + list(opts)

    rc = run.main(["--workload", workload, "--seed", "2147483999", "--seconds", seconds,
                   "--trace", "0"], device="cpu", tweak=tweak)
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    return json.loads(out[-1])


@pytest.mark.parametrize("workload", ["dropout_bayes_od_mc_b8", "clsvar_standard_nms_b8"])
def test_inference_float32(capsys, workload):
    result = run_cell(capsys, workload, ["PARALLEL.COMPUTE_DTYPE", "float32"])
    checks = {k: v["value"] for k, v in result["checks"].items()}
    assert checks["logit_gap"] < 1e-5 and checks["delta_gap"] < 1e-5
    assert checks["det_gap"] == 0.0 and checks["missing_batches"] == 0.0
    assert result["correct"] and result["attempted"] >= 4


@pytest.mark.parametrize("workload", ["dropout_train_b4"])
def test_training_float32(capsys, workload):
    result = run_cell(capsys, workload, ["PARALLEL.COMPUTE_DTYPE", "float32"], seconds="1")
    checks = {k: v["value"] for k, v in result["checks"].items()}
    assert checks["loss_gap"] < 1e-6 and checks["grad_gap"] < 1e-5
    # A leaf's change over three steps is a difference of float32 weights
    # that are larger by up to ~10^3: its norm carries their rounding.
    assert checks["update_gap"] < 5e-3
    assert result["correct"]


def test_k1_bits_match_the_ports_plain_dropout():
    from pod_compare_tpu_torch.ops.kernels import dropout as kd

    x = torch.randn(3, 16, 5, 7).contiguous(memory_format=torch.channels_last)
    for shared in (False, True):
        got = kd.dropout_plain(x, 1234567890123, 0.2, shared, 8, relu=True)
        keep = bits.keep_nchw(x.shape, 8, 1234567890123, 0.2, shared, "cpu")
        want = torch.where(keep & (x > 0), x * 1.25, torch.zeros(()))
        assert torch.equal(got, want)


def test_k2_draws_match_the_ports_plain_focal():
    from pod_compare_tpu_torch.ops.kernels import focal as kf

    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 300, 7, generator=g)
    s = torch.randn(2, 300, 7, generator=g)
    t = (torch.rand(2, 300, 7, generator=g) < 0.1).float()
    seed = -123456789
    loss, _, _ = kf.focal_plain(x, s, t, seed, 10)
    z = bits.focal_normals(x.numel(), seed, 10, "cpu").reshape((10,) + x.shape)
    y = x[None] + torch.exp(0.5 * s.clamp(-10, 10))[None] * z
    want = rtrain.focal(y, t[None], 0.25, 2.0).mean(dim=0)
    torch.testing.assert_close(loss, want, rtol=1e-5, atol=1e-7)
