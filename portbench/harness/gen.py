"""The inputs of a run, made on the device from the seed: weights, canvases
and training batches. One general generator, driven by the parameters of
the configuration and traffic files.

Weights (``weights``): every convolution's weight from one normal draw,
scaled per tensor; FrozenBN biases from a second. The backbone is
He-scaled (the stem's gain divided by 128^2 for raw pixels, each residual
branch's last FrozenBN scaling by 0.5, so activations grow slowly through
the 16 blocks). The head is either He-scaled and then tempered
(``temper``: inference, so that candidates pass the score threshold and
boxes fuse) or drawn as the program initialises a head for training
(towers and outputs N(0, 0.01), the class prior's bias, the class
log-variances' bias -10, the covariance weights N(0, 1e-4)).

Canvases (``canvases``): uint8 BGR, noise in [0, 40) under twelve smooth
random blobs an image, the image's rows and columns inside the canvas and
zeros in the padding. Ground truth (``train_batches``): a Poisson number of
boxes an image around `gt_mean`, from 1 to `max_gt`, sides log-uniform in
pixels over `side_px`, classes drawn in proportion to `class_weights`.
"""

import math
from typing import Dict, Sequence

import torch

from portbench.reference import model as ref


def _gain(name: str, head_kind: str):
    """(std of the weight, bias fill) of a weight tensor by its name."""
    if name.startswith("backbone.bottom_up."):
        if name.endswith("stem.conv1.weight"):
            return "he", 2.0 / 128.0 ** 2
        if ".shortcut." in name:
            return "he", 1.0
        return "he", 2.0
    if name.startswith("backbone."):
        return "he", 2.0 if "top_block.p7" in name else 1.0
    if head_kind == "tempered":
        return "he", 2.0 if "_subnet." in name else 1.0
    return "std", 1e-4 if "bbox_cov" in name else 0.01


def weights(seed: int, shapes: Dict[str, tuple], head_kind: str, device,
            prior_prob: float = 0.01) -> Dict[str, torch.Tensor]:
    """The state dict of `shapes` from `seed`, float32 on `device`."""
    g = torch.Generator(device=device).manual_seed(seed)
    conv_names = [k for k, s in shapes.items() if len(s) == 4]
    bn_bias = [k for k in shapes if k.endswith(".norm.bias")]
    total = sum(math.prod(shapes[k]) for k in conv_names)
    z = torch.randn(total, generator=g, device=device)
    zb = torch.randn(sum(shapes[k][0] for k in bn_bias), generator=g, device=device)
    sd, at = {}, 0
    for k in conv_names:
        n = math.prod(shapes[k])
        kind, gain = _gain(k, head_kind)
        cout, cin, kh, kw = shapes[k]
        std = math.sqrt(gain / (kh * kw * cin)) if kind == "he" else gain
        sd[k] = (z[at:at + n] * std).reshape(shapes[k])
        at += n
    at = 0
    for k in bn_bias:
        n = shapes[k][0]
        sd[k] = 0.1 * zb[at:at + n]
        at += n
    for k, s in shapes.items():
        if k in sd:
            continue
        if k.endswith(".norm.weight"):
            sd[k] = torch.full(s, 0.5 if ".conv3.norm." in k else 1.0, device=device)
        elif k.endswith(".norm.running_var"):
            sd[k] = torch.ones(s, device=device)
        else:  # running means and conv biases
            sd[k] = torch.zeros(s, device=device)
    if head_kind == "init":
        sd["head.cls_score.bias"].fill_(-math.log((1.0 - prior_prob) / prior_prob))
        if "head.cls_var.bias" in sd:
            sd["head.cls_var.bias"].fill_(-10.0)
    return sd


def temper(sd: Dict[str, torch.Tensor], probe: Dict[str, torch.Tensor], num_classes: int):
    """Scale the output convs so that the probe's logits lie within +-2,
    deltas within +-0.05 and log-variances within +-1, then bias them as a
    trained detector on crowded scenes: class 0 preferred (+1.5), boxes 6x
    their anchors (neighbouring anchors overlap at IoU > 0.9 and BayesOD
    fuses them), small variances. `probe` is one deterministic forward of
    the plain reference."""
    targets = {"cls_score": ("box_cls", 2.0), "bbox_pred": ("box_delta", 0.05),
               "cls_var": ("box_cls_var", 1.0), "bbox_cov": ("box_reg_var", 1.0)}
    sd = dict(sd)
    for conv, (key, target) in targets.items():
        if probe.get(key) is None:
            continue
        peak = float(probe[key].abs().max())
        if not math.isfinite(peak) or peak == 0.0:
            raise RuntimeError(f"the tempering probe gave {key} peak {peak}")
        sd[f"head.{conv}.weight"] = sd[f"head.{conv}.weight"] * (target / peak)
        sd[f"head.{conv}.bias"] = sd[f"head.{conv}.bias"] * (target / peak)
    cls = sd["head.cls_score.bias"].reshape(-1, num_classes).clone()
    cls[:, 0] += 1.5
    sd["head.cls_score.bias"] = cls.reshape(-1)
    box = sd["head.bbox_pred.bias"].reshape(-1, 4).clone()
    box[:, 2:] += math.log(6.0)
    sd["head.bbox_pred.bias"] = box.reshape(-1)
    if "head.cls_var.bias" in sd:
        sd["head.cls_var.bias"] = sd["head.cls_var.bias"] - 6.0
    if "head.bbox_cov.bias" in sd:
        sd["head.bbox_cov.bias"] = sd["head.bbox_cov.bias"] - 4.0
    return sd


def canvases(seed: int, count: int, canvas: Sequence[int], image: Sequence[int],
             device, blobs: int = 12) -> torch.Tensor:
    """(count, H, W, 3) uint8 canvases on `device`, the image in the top
    left (image[0] x image[1]) and zeros in the padding."""
    g = torch.Generator(device=device).manual_seed(seed)
    h, w = image
    out = torch.zeros((count, canvas[0], canvas[1], 3), dtype=torch.uint8, device=device)
    yy = torch.arange(h, device=device, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=device, dtype=torch.float32)[None, :]
    params = torch.rand((count, blobs, 6), generator=g, device=device)
    noise = torch.randint(0, 40, (count, h, w, 3), generator=g, device=device)
    for i in range(count):
        img = noise[i].float()
        for cy, cx, r, c0, c1, c2 in params[i].tolist():
            cy, cx = cy * h, cx * w
            r = (0.05 + 0.2 * r) * min(h, w)
            blob = torch.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r * r))
            color = torch.tensor([c0, c1, c2], device=device) * 195.0 + 60.0
            img = img + blob[..., None] * color
        out[i, :h, :w] = img.clamp(0, 255).to(torch.uint8)
    return out


def train_batches(seed: int, count: int, batch: int, canvas: Sequence[int],
                  image: Sequence[int], device, gt_mean: float, max_gt: int,
                  class_weights: Sequence[float], side_px=(16.0, 400.0)):
    """`count` distinct batches of `batch` images with their padded ground
    truth, on `device`."""
    images = canvases(seed, count * batch, canvas, image, device)
    g = torch.Generator(device=device).manual_seed(seed + 1)
    n = count * batch
    h, w = image
    num = torch.poisson(torch.full((n,), float(gt_mean), device=device), generator=g)
    num = num.clamp(1, max_gt).long()
    lo, hi = math.log(side_px[0]), math.log(side_px[1])
    u = torch.rand((n, max_gt, 4), generator=g, device=device)
    bw = torch.exp(lo + (hi - lo) * u[..., 0]).clamp(max=w - 1)
    bh = torch.exp(lo + (hi - lo) * u[..., 1]).clamp(max=h - 1)
    x0 = u[..., 2] * (w - bw)
    y0 = u[..., 3] * (h - bh)
    boxes = torch.stack([x0, y0, x0 + bw, y0 + bh], dim=-1)
    probs = torch.tensor(class_weights, device=device, dtype=torch.float32)
    classes = torch.multinomial(probs, n * max_gt, replacement=True, generator=g).reshape(
        n, max_gt)
    valid = torch.arange(max_gt, device=device)[None] < num[:, None]
    boxes = torch.where(valid[..., None], boxes, torch.zeros((), device=device))
    classes = torch.where(valid, classes, torch.zeros((), dtype=torch.long, device=device))
    out = []
    for i in range(count):
        s = slice(i * batch, (i + 1) * batch)
        out.append({"images": images[s], "gt_boxes": boxes[s], "gt_classes": classes[s],
                    "gt_valid": valid[s]})
    return out


def reference_shapes(config: dict) -> Dict[str, tuple]:
    m = config["model"]
    return ref.parameter_shapes(m["num_classes"], m["num_anchors"], m["num_convs"],
                                m["cls_var"], m["bbox_cov_dims"])
