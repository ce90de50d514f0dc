#!/usr/bin/env python3
"""Why the sampled box bank keys its normals by anchor.

The mc_iid flagship (CLS_SAMPLING and BOX_SAMPLING mc_iid, S = 10 and 1000;
BayesOD + 3 MC-dropout runs) at 128x128 in float32, as chip_smoke.py's
phase 9 holds it against the CPU, with the box bank's normals keyed by
the candidates' anchors (the port's) or, with --key rank, by their rank
among the candidates (the row of each candidate's position), as a stream
drawn in candidate order would key them.

    python tools/torch_sampling_keying.py [--key anchor|rank] [--seed N]
    python tools/torch_sampling_keying.py --device cpu [--key ...] [--noise 1e-6] [--trials 4]

On the card it prints the GPU's detections against the CPU's (matched by
class and IoU as chip_smoke.held_against_cpu matches them): the flips, the
largest box errors relative to each box's largest coordinate, and for the
worst one the centre candidate's rank and anchor on each side; then the
same with the CPU's normals fed to the GPU run. With --device cpu it holds
the CPU's detections against the same call with the mean head outputs
moved by relative noise of --noise, --trials times: two devices' rounding
in small. It imports no JAX.
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from pod_compare_tpu_torch.inference import core as pcore  # noqa: E402
from pod_compare_tpu_torch.inference import modes as pmodes  # noqa: E402
from pod_compare_tpu_torch.inference import predictor as ppredictor  # noqa: E402
from pod_compare_tpu_torch.ops.kernels import normal as knormal  # noqa: E402

SIZE = (128, 128)
OPTS = ("PARALLEL.COMPUTE_DTYPE", "float32", "PROBABILISTIC_INFERENCE.MC_DROPOUT.NUM_RUNS", 3)


def key_by_rank() -> None:
    """Draw each candidate's box normals from the row of its rank."""
    keyed = pcore.sampled_box_moments

    def by_rank(*args, index=None, rows=0, **kwargs):
        return keyed(*args, **kwargs)

    pcore.sampled_box_moments = by_rank


def record_centres(record: list) -> None:
    """Append each image's (centre candidate ranks, their anchors) to `record`."""
    clusters = pmodes._nms_clusters

    def recorded(cands, *args):
        keep, cluster_mask, fusion_mask = clusters(cands, *args)
        record.append((keep.indices.cpu(), cands.anchor_idx[keep.indices].cpu()))
        return keep, cluster_mask, fusion_mask

    pmodes._nms_clusters = recorded


def setup(seed: int):
    images = torch.from_numpy(cs.canvases(seed + 1, SIZE, cs.BATCH))
    flagship = cs.mode_config(cs.INFER_CFG, OPTS)
    sd = cs.convert.from_jax_params(cs.random_jax_params(seed + 1, cs.NUM_CLASSES))
    tempered = cs.temper_head(sd, flagship, images[:1], "cpu")
    name, infer, extra = [c for c in cs.MODE_CASES if c[0] == "bayes_od_mc_dropout_mc_iid"][0]
    return images, tempered, cs.mode_config(infer, tuple(OPTS) + tuple(extra))


def detect(cfg, tempered, images, device, seed: int, record: list):
    sizes = np.array([SIZE] * cs.BATCH, np.float32)
    predictor = cs.mode_predictor(cfg, SIZE, tempered, None, device)
    record.clear()
    dets = predictor(images, sizes, sizes, generator=torch.Generator().manual_seed(seed))
    return type(dets)(*[None if f is None else f.cpu() for f in dets]), list(record)


def report(tag: str, got, got_centres, want, want_centres) -> None:
    """The flips and worst box errors of `got` against `want`."""
    pairs, flips = cs.match_detections(got, want)
    errs = sorted(((float((got.boxes[b, j] - want.boxes[b, i]).abs().max()
                          / want.boxes[b, i].abs().max()), b, i, j) for b, i, j in pairs),
                  reverse=True)
    print(f"{tag}: {len(pairs)}/{int(want.valid.sum())} matched, {flips} flips; largest box "
          f"errors {[f'{e:.2e}' for e, *_ in errs[:3]]}")
    e, b, i, j = errs[0]
    print(f"  worst: image {b}, detection {i} (reference) / {j}: centre candidate rank "
          f"{int(want_centres[b][0][i])} / {int(got_centres[b][0][j])}, anchor "
          f"{int(want_centres[b][1][i])} / {int(got_centres[b][1][j])}; cluster size "
          f"{int(want.cluster_size[b, i])} / {int(got.cluster_size[b, j])}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--key", choices=("anchor", "rank"), default="anchor")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--noise", type=float, default=1e-6)
    parser.add_argument("--trials", type=int, default=4)
    args = parser.parse_args()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.key == "rank":
        key_by_rank()
    record = []
    record_centres(record)
    images, tempered, cfg = setup(args.seed)
    want, want_centres = detect(cfg, tempered, images, "cpu", args.seed, record)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("torch_sampling_keying: no CUDA device", file=sys.stderr)
            return 2
        print(cs.card_line())
        got, centres = detect(cfg, tempered, images, "cuda", args.seed, record)
        report(f"keyed by {args.key}, GPU against CPU", got, centres, want, want_centres)
        plain = knormal.normal_cuda
        knormal.normal_cuda = lambda shape, seed, offset, like, index=None, rows=0: (
            knormal.normal_plain(shape, seed, offset, like.dtype, "cpu",
                                 None if index is None else index.cpu(), rows).to(like.device))
        got, centres = detect(cfg, tempered, images, "cuda", args.seed, record)
        knormal.normal_cuda = plain
        report(f"keyed by {args.key}, GPU with the CPU's normals against CPU", got, centres,
               want, want_centres)
        return 0
    outputs = ppredictor.PipelineModule._head_outputs
    for trial in range(args.trials):
        gen = torch.Generator().manual_seed(100 + trial)

        def noisy(self, imgs, dropout_seeds, tower_dropouts=None):
            mean, run_deltas = outputs(self, imgs, dropout_seeds, tower_dropouts)
            return {k: None if v is None else v * (1 + args.noise * torch.randn(
                v.shape, generator=gen)) for k, v in mean.items()}, run_deltas

        ppredictor.PipelineModule._head_outputs = noisy
        got, centres = detect(cfg, tempered, images, "cpu", args.seed, record)
        ppredictor.PipelineModule._head_outputs = outputs
        report(f"keyed by {args.key}, CPU with {args.noise:g} noise (trial {trial}) against CPU",
               got, centres, want, want_centres)
    return 0


if __name__ == "__main__":
    sys.exit(main())
