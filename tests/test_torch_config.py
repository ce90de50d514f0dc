"""The port's config: its YAML-subset reader against PyYAML on every config
of the repository, and the merged train + inference trees against the JAX
package's, pair by pair, less the keys only the port has (``PORT_ONLY``)."""

import copy
import glob
import os

import pytest
import yaml

from pod_compare_tpu import configs_dir
from pod_compare_tpu.config import get_cfg as jax_get_cfg
from pod_compare_tpu_torch.config import get_cfg, merge_configs, parse_yaml
from pod_compare_tpu_torch.config.setup import configs_dir as port_configs_dir
from pod_compare_tpu_torch.models import build_model

CONFIGS = sorted(
    os.path.relpath(p, configs_dir())
    for p in glob.glob(os.path.join(configs_dir(), "**", "*.yaml"), recursive=True)
)
TRAIN = [c for c in CONFIGS if c.startswith("BDD-Detection")]
INFERENCE = [c for c in CONFIGS if c.startswith("Inference")]


def test_the_repository_configs_are_found():
    assert port_configs_dir() == configs_dir()
    assert len(CONFIGS) == 18 and len(TRAIN) == 9 and len(INFERENCE) == 8


@pytest.mark.parametrize("name", CONFIGS)
def test_yaml_reader_matches_pyyaml(name):
    with open(os.path.join(configs_dir(), name)) as f:
        text = f.read()
    assert parse_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize(
    "text",
    [
        "A:\n"
        "    B: [[1, 2.5], \"x # y\", 'it''s', -3]  # trailing\n"
        "    C: (60000, 80000)\n"
        "    D: 1e-4\n"
        "    E: 1.0e-4\n"
        "    F:\n"
        "    G: ~\n"
        "# full-line comment\n"
        "H: True\n"
        "I: off\n"
        "J: .5\n",
        "A: it's  # an apostrophe inside a plain scalar\n",
        "A: 'a '' # b'  # c\nB: \"x \\\" # y\" # z\n",
        "A: [\"a#b\", 'c # d']\nB: a#b\n",
    ],
)
def test_yaml_reader_scalars_lists_and_comments(text):
    assert parse_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize(
    "text",
    ["A:\n  - 1\n", "A: {b: 1}\n", "A: &x 1\n", "A: |\n  text\n", "A: 1\n  B: 2\n",
     "A:\n    B: 1\n  C: 2\n", "A: 1\nA: 2\n", "A: [1, 2\n"],
)
def test_yaml_reader_refuses_what_it_does_not_support(text):
    with pytest.raises(ValueError):
        parse_yaml(text)


# Keys only the port has, with their defaults (ResNeXt's, detectron2's
# ResNet values); the trees are compared without them.
PORT_ONLY = {("MODEL", "RESNETS", "NUM_GROUPS"): 1, ("MODEL", "RESNETS", "WIDTH_PER_GROUP"): 64}


def shared_tree(tree, defaults=True):
    """`tree` (a to_dict()) without the port-only keys, which hold their
    defaults when `defaults`."""
    tree = copy.deepcopy(tree)
    for path, value in PORT_ONLY.items():
        node = tree
        for key in path[:-1]:
            node = node[key]
        assert not defaults or node[path[-1]] == value, path
        del node[path[-1]]
    return tree


def test_defaults_match():
    assert shared_tree(get_cfg().to_dict()) == jax_get_cfg().to_dict()


@pytest.mark.parametrize("train", TRAIN)
@pytest.mark.parametrize("inference", INFERENCE)
def test_train_and_inference_configs_merge_alike(train, inference):
    theirs = jax_get_cfg()
    theirs.merge_from_file(os.path.join(configs_dir(), train))
    theirs.merge_from_file(os.path.join(configs_dir(), inference))
    assert shared_tree(merge_configs(train, inference).to_dict()) == theirs.to_dict()


def test_the_x101_opts_build_the_published_shapes():
    opts = ["MODEL.RESNETS.DEPTH", 101, "MODEL.RESNETS.NUM_GROUPS", 32,
            "MODEL.RESNETS.WIDTH_PER_GROUP", 8, "MODEL.RESNETS.STRIDE_IN_1X1", False,
            "MODEL.PIXEL_STD", "[57.375, 57.120, 58.395]"]
    cfg = merge_configs(TRAIN[0], INFERENCE[0], opts)
    assert cfg.MODEL.PIXEL_STD == [57.375, 57.120, 58.395]
    bottom_up = build_model(cfg).backbone.bottom_up
    assert bottom_up.res4[0].conv2.weight.shape == (1024, 32, 3, 3)
    assert bottom_up.res4[0].conv2.groups == 32 and len(bottom_up.res4) == 23
    assert bottom_up.res3[0].conv1.stride == (1, 1) and bottom_up.res3[0].conv2.stride == (2, 2)
    assert sum(p.numel() for n, p in bottom_up.named_parameters()) == 86_539_456


def test_overrides_and_unknown_keys():
    cfg = merge_configs(TRAIN[0], INFERENCE[0], ["SOLVER.STEPS", "(1, 2)", "TEST.EVAL_PERIOD", 5])
    assert cfg.SOLVER.STEPS == (1, 2) and cfg.TEST.EVAL_PERIOD == 5
    assert isinstance(get_cfg().SOLVER.STEPS, tuple)
    with pytest.raises(KeyError):
        merge_configs(TRAIN[0], "", ["MODEL.NOT_A_KEY", 1])
    frozen = get_cfg().freeze()
    with pytest.raises(AttributeError):
        frozen.SEED = 3
