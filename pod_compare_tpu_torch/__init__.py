"""pod_compare_tpu_torch: the PyTorch/CUDA port of pod_compare_tpu.

Probabilistic RetinaNet-R50-FPN inference (BayesOD + MC-dropout),
training (loss attenuation, annealed NLL, per-sample dropout) and
evaluation (``cli.apply_net``: images on disk to mAP, NLL, calibration and
MUE) in PyTorch, with hand-written CUDA kernels for Hopper under
``csrc/`` in place of the JAX package's Pallas TPU kernels. It imports
neither JAX nor ``pod_compare_tpu``; the tests hold it against the JAX
package.
"""

__version__ = "0.1.0"
