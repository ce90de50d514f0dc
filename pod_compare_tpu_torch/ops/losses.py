"""Detection losses in PyTorch.

Counterpart of ``pod_compare_tpu/ops/losses.py``: focal, smooth L1, the
stochastic (loss-attenuation) focal loss, the diagonal and full Gaussian NLL
box losses, second-moment matching, annealing and the EMA loss normalizer.
Every loss takes explicit validity or positivity masks and returns a masked
sum; the caller divides by the loss normalizer.
"""

import torch

from pod_compare_tpu_torch.ops.kernels.focal import LOG_VAR_CLAMP, stochastic_focal_elem


def sigmoid_focal_loss(logits, targets, alpha: float = 0.25, gamma: float = 2.0):
    """Elementwise focal loss on logits; `targets` is one-hot {0, 1}."""
    p = torch.sigmoid(logits)
    ce = torch.clamp_min(logits, 0.0) - logits * targets + torch.log1p(
        torch.exp(-logits.abs())
    )
    p_t = p * targets + (1.0 - p) * (1.0 - targets)
    loss = ce * (1.0 - p_t) ** gamma
    if alpha >= 0:
        alpha_t = alpha * targets + (1.0 - alpha) * (1.0 - targets)
        loss = alpha_t * loss
    return loss


def smooth_l1_loss(pred, target, beta: float = 0.0):
    """Elementwise smooth L1; beta = 0 is plain L1."""
    diff = (pred - target).abs()
    if beta <= 0.0:
        return diff
    return torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)


def _masked_sum(loss, mask):
    """Sum of `loss` where `mask` (broadcast over trailing axes) holds."""
    while mask.dim() < loss.dim():
        mask = mask[..., None]
    return torch.where(mask, loss, torch.zeros((), dtype=loss.dtype, device=loss.device)).sum()


def stochastic_focal_loss(
    logits,
    logit_log_vars,
    targets,
    valid_mask,
    num_samples: int,
    seed: int,
    alpha: float = 0.25,
    gamma: float = 2.0,
    shared_batch: bool = False,
    impl: str = "threefry",
):
    """Loss-attenuation classification loss: the focal loss averaged over
    `num_samples` logits drawn from N(logit, exp(clip(log_var, ±10))),
    summed over valid anchors and classes.

    impl 'pallas' runs the fused kernel (``ops/kernels/focal.py``; its
    stream is keyed by the int32 `seed` and it always draws per element, so
    it ignores `shared_batch`). impl 'threefry' draws a (S, ...) bank of
    normals with ``torch.randn`` from a generator seeded with `seed` on the
    logits' device; with `shared_batch` one (S, R, K) bank is broadcast over
    the batch.
    """
    if impl == "pallas":
        targets_b = torch.broadcast_to(targets, logits.shape).float()
        loss_elem = stochastic_focal_elem(
            logits.float(), logit_log_vars.float(), targets_b, seed, num_samples, alpha, gamma
        )
        return _masked_sum(loss_elem, valid_mask)
    if impl != "threefry":
        raise ValueError(f"Unknown stochastic focal impl {impl!r}")
    gen = torch.Generator(device=logits.device).manual_seed(seed)
    std = torch.sqrt(torch.exp(torch.clamp(logit_log_vars, -LOG_VAR_CLAMP, LOG_VAR_CLAMP)))
    if shared_batch and logits.dim() == 3:
        shape = (num_samples, 1) + tuple(logits.shape[1:])
    else:
        shape = (num_samples,) + tuple(logits.shape)
    noise = torch.randn(shape, generator=gen, device=logits.device, dtype=logits.dtype)
    loss = sigmoid_focal_loss(logits[None] + noise * std[None], targets[None], alpha, gamma)
    return _masked_sum(loss, valid_mask[None]) / num_samples


def nll_box_loss(pred_deltas, gt_deltas, pred_log_vars, pos_mask, beta: float = 0.0,
                 log_var_clamp: float = 7.0):
    """Diagonal-Gaussian NLL box loss 0.5·exp(-s)·smoothL1 + 0.5·s, with s
    the log-variance clamped to ±`log_var_clamp`; masked sum."""
    s = torch.clamp(pred_log_vars, -log_var_clamp, log_var_clamp)
    base = smooth_l1_loss(pred_deltas, gt_deltas, beta)
    return _masked_sum(0.5 * torch.exp(-s) * base + 0.5 * s, pos_mask)


def mvn_nll_box_loss(pred_deltas, gt_deltas, pred_cov_params, pos_mask,
                     log_var_clamp: float = 7.0):
    """Full-covariance Gaussian NLL box loss (masked sum),
    0.5·||L^-1 (gt - pred)||^2 + sum_i log L_ii, with L the Cholesky factor
    of the 10-parameter head output ([s1..s4, l21, l31, l32, l41, l42, l43],
    diagonal sqrt(exp(s_i))), solved by forward substitution."""
    s = torch.clamp(pred_cov_params[..., 0:4], -log_var_clamp, log_var_clamp)
    inv_d = torch.exp(-0.5 * s)
    d = gt_deltas - pred_deltas
    l21, l31, l32, l41, l42, l43 = (pred_cov_params[..., i] for i in range(4, 10))
    z1 = d[..., 0] * inv_d[..., 0]
    z2 = (d[..., 1] - l21 * z1) * inv_d[..., 1]
    z3 = (d[..., 2] - l31 * z1 - l32 * z2) * inv_d[..., 2]
    z4 = (d[..., 3] - l41 * z1 - l42 * z2 - l43 * z3) * inv_d[..., 3]
    maha = z1 * z1 + z2 * z2 + z3 * z3 + z4 * z4
    loss = 0.5 * maha + 0.5 * s.sum(dim=-1)
    return _masked_sum(loss, pos_mask)


def second_moment_matching_box_loss(pred_deltas, gt_deltas, pred_cov_params, pos_mask,
                                    beta: float = 0.0, log_var_clamp: float = 7.0):
    """Second-moment matching (masked sum): smoothL1(mu, gt) plus
    smoothL1(Sigma, r r^T) with the residual r = gt - mu held constant;
    per-dimension variances for a 4-parameter head, the whole matrix L L^T
    for a 10-parameter head."""
    residual = (gt_deltas - pred_deltas).detach()
    base = smooth_l1_loss(pred_deltas, gt_deltas, beta)
    if pred_cov_params.shape[-1] == 4:
        s = torch.clamp(pred_cov_params, -log_var_clamp, log_var_clamp)
        var_term = smooth_l1_loss(torch.exp(s), residual * residual, beta)
        loss = (base + var_term).sum(dim=-1)
    else:
        from pod_compare_tpu_torch.ops.gaussian import covariance_output_to_cholesky

        params = torch.cat(
            [torch.clamp(pred_cov_params[..., 0:4], -log_var_clamp, log_var_clamp),
             pred_cov_params[..., 4:]], dim=-1,
        )
        chol = covariance_output_to_cholesky(params)
        cov = chol @ chol.transpose(-1, -2)
        outer = residual[..., :, None] * residual[..., None, :]
        loss = base.sum(dim=-1) + smooth_l1_loss(cov, outer, beta).sum(dim=(-2, -1))
    return _masked_sum(loss, pos_mask)


def annealing_weight(step, annealing_step: int) -> torch.Tensor:
    """Exponential probabilistic-loss annealing (100^w - 1)/99 with
    w = min(1, step/annealing_step), in float32."""
    step = torch.as_tensor(step, dtype=torch.float32)
    w = torch.clamp_max(step / float(max(annealing_step, 1)), 1.0)
    return (torch.pow(torch.tensor(100.0), w) - 1.0) / 99.0


def masked_sum_focal_loss(logits, targets, valid_mask, alpha: float = 0.25,
                          gamma: float = 2.0):
    """Focal loss summed over valid anchors and classes."""
    return _masked_sum(sigmoid_focal_loss(logits, targets, alpha, gamma), valid_mask)


def masked_sum_smooth_l1(pred, target, pos_mask, beta: float = 0.0):
    """Smooth-L1 box loss summed over positive anchors."""
    return _masked_sum(smooth_l1_loss(pred, target, beta), pos_mask)


def ema_loss_normalizer(normalizer, num_pos, momentum: float = 0.9):
    """EMA of the positive-anchor count that normalizes both losses:
    momentum·normalizer + (1 - momentum)·max(num_pos, 1)."""
    return momentum * normalizer + (1.0 - momentum) * torch.clamp_min(num_pos, 1.0)
