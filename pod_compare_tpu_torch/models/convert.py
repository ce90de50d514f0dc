"""JAX parameter tree -> state dict of this package (detectron2 names).

The inverse of ``pod_compare_tpu/train/torch_convert.py``: conv kernels go
from HWIO to OIHW, FrozenBN ``scale/bias/mean/var`` become
``norm.weight/bias/running_mean/running_var``, and the flax module names map
back onto the reference namespace:

  resnet/stem_conv1, stem_norm1          -> backbone.bottom_up.stem.conv1(.norm)
  resnet/res{S}_block{B}/conv{i}, norm{i} -> backbone.bottom_up.res{S}.{B}.conv{i}(.norm)
  resnet/res{S}_block{B}/shortcut(_norm)  -> backbone.bottom_up.res{S}.{B}.shortcut(.norm)
  fpn/lateral_res{L}, output_res{L}       -> backbone.fpn_lateral{L}, fpn_output{L}
  fpn/p6, p7                              -> backbone.top_block.p6, p7
  head/{cls,bbox}_subnet_conv{i}          -> head.{cls,bbox}_subnet.{2i}
  head/{cls_score,bbox_pred,cls_var,bbox_cov}

It takes plain nested dicts of numpy arrays and needs no JAX.
``load_reference_checkpoint`` reads a reference checkpoint (a detectron2
``.pkl`` or a torch ``.pth``) for ``from_reference_state_dict``.
"""

import pickle
import re
from typing import Dict, Mapping

import numpy as np
import torch

_NORM_MAP = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}


def _tensor(value, transpose: bool = False) -> torch.Tensor:
    a = np.array(value, np.float32)
    if transpose:
        a = np.transpose(a, (3, 2, 0, 1))  # HWIO -> OIHW
    return torch.from_numpy(np.ascontiguousarray(a))


def _conv(out: Dict, name: str, leaves: Mapping) -> None:
    for leaf, value in leaves.items():
        if leaf == "kernel":
            out[f"{name}.weight"] = _tensor(value, transpose=True)
        elif leaf == "bias":
            out[f"{name}.bias"] = _tensor(value)
        else:
            raise KeyError(f"Unrecognized conv leaf {name}/{leaf}")


def _norm(out: Dict, name: str, leaves: Mapping) -> None:
    for leaf, value in leaves.items():
        out[f"{name}.norm.{_NORM_MAP[leaf]}"] = _tensor(value)


def _resnet(out: Dict, tree: Mapping) -> None:
    pre = "backbone.bottom_up."
    for mod, leaves in tree.items():
        if mod == "stem_conv1":
            _conv(out, pre + "stem.conv1", leaves)
            continue
        if mod == "stem_norm1":
            _norm(out, pre + "stem.conv1", leaves)
            continue
        m = re.match(r"res(\d)_block(\d+)$", mod)
        if not m:
            raise KeyError(f"Unrecognized resnet module {mod}")
        base = f"{pre}res{m.group(1)}.{m.group(2)}"
        for sub, sub_leaves in leaves.items():
            if sub in ("conv1", "conv2", "conv3", "shortcut"):
                _conv(out, f"{base}.{sub}", sub_leaves)
            elif sub in ("norm1", "norm2", "norm3"):
                _norm(out, f"{base}.conv{sub[-1]}", sub_leaves)
            elif sub == "shortcut_norm":
                _norm(out, f"{base}.shortcut", sub_leaves)
            else:
                raise KeyError(f"Unrecognized block module {mod}/{sub}")


def _fpn(out: Dict, tree: Mapping) -> None:
    for mod, leaves in tree.items():
        m = re.match(r"(lateral|output)_res(\d)$", mod)
        if m:
            _conv(out, f"backbone.fpn_{m.group(1)}{m.group(2)}", leaves)
        elif mod in ("p6", "p7"):
            _conv(out, f"backbone.top_block.{mod}", leaves)
        else:
            raise KeyError(f"Unrecognized fpn module {mod}")


def _head(out: Dict, tree: Mapping) -> None:
    for mod, leaves in tree.items():
        m = re.match(r"(cls|bbox)_subnet_conv(\d+)$", mod)
        if m:
            _conv(out, f"head.{m.group(1)}_subnet.{2 * int(m.group(2))}", leaves)
        elif mod in ("cls_score", "bbox_pred", "cls_var", "bbox_cov"):
            _conv(out, f"head.{mod}", leaves)
        else:
            raise KeyError(f"Unrecognized head module {mod}")


def from_jax_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """State dict (float32 CPU tensors) from the JAX package's parameter
    tree, given as nested dicts of numpy arrays."""
    out: Dict[str, torch.Tensor] = {}
    converters = {"resnet": _resnet, "fpn": _fpn, "head": _head}
    for top, tree in params.items():
        if top not in converters:
            raise KeyError(f"Unrecognized top-level module {top}")
        converters[top](out, tree)
    return out


def from_reference_state_dict(state: Mapping) -> Dict[str, torch.Tensor]:
    """State dict of this package from a reference (detectron2) checkpoint:
    a full model in the ``backbone.*``/``head.*`` namespace or a bare
    backbone (``stem.*``, ``res{S}.*``). Head tower indices are renumbered
    by order of appearance, since the reference's Sequential also counts
    its ReLU and Dropout modules; config-level constants are dropped.
    Like the JAX package's ``convert_torch_state_dict``, unknown keys raise.
    Tensors keep their shapes, so a ResNeXt's grouped ``conv2`` weights,
    (mid, mid / NUM_GROUPS, 3, 3), load as they are (FAIR's X-101-32x8d:
    res4's (1024, 32, 3, 3)) into a model built with the same keys."""
    out: Dict[str, torch.Tensor] = {}
    towers: Dict[str, Dict[int, int]] = {"cls": {}, "bbox": {}}
    for key, value in state.items():
        if key in ("pixel_mean", "pixel_std") or key.startswith("anchor_generator"):
            continue
        if re.match(r"(stem|res\d)\.", key):
            key = "backbone.bottom_up." + key
        m = re.match(r"head\.(cls|bbox)_subnet\.(\d+)\.(weight|bias)$", key)
        if m:
            table = towers[m.group(1)]
            index = table.setdefault(int(m.group(2)), len(table))
            key = f"head.{m.group(1)}_subnet.{2 * index}.{m.group(3)}"
        elif not re.match(
            r"(backbone\.(bottom_up\.|fpn_|top_block\.)|head\.(cls_score|bbox_pred|cls_var|"
            r"bbox_cov)\.)", key
        ):
            raise KeyError(f"Unrecognized reference checkpoint key: {key}")
        out[key] = torch.as_tensor(np.asarray(value, np.float32))
    return out


def load_reference_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """The flat state dict of a reference checkpoint, as the JAX package's
    ``train/torch_convert.py::load_reference_checkpoint`` reads it: a
    detectron2 ``.pkl`` (a pickle written under Python 2, hence latin1, of
    numpy arrays, the weights under ``"model"`` or at the top level) or a
    torch ``.pth`` (tensors, under ``"model"`` or at the top level). A
    ``.pkl`` is unpickled, which runs whatever code it names: load only
    files from a source you trust, as with detectron2's own loader."""
    if path.endswith(".pkl"):
        with open(path, "rb") as f:
            data = pickle.load(f, encoding="latin1")
        state = data.get("model", data)
        return {k: np.asarray(v) for k, v in state.items()}
    data = torch.load(path, map_location="cpu", weights_only=True)
    state = data.get("model", data)
    return {k: v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in state.items()}
