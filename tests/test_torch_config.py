"""The port's config: its YAML-subset reader against PyYAML on every config
of the repository, and the merged train + inference trees against the JAX
package's, pair by pair."""

import glob
import os

import pytest
import yaml

from pod_compare_tpu import configs_dir
from pod_compare_tpu.config import get_cfg as jax_get_cfg
from pod_compare_tpu_torch.config import get_cfg, merge_configs, parse_yaml
from pod_compare_tpu_torch.config.setup import configs_dir as port_configs_dir

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


def test_defaults_match():
    assert get_cfg().to_dict() == jax_get_cfg().to_dict()


@pytest.mark.parametrize("train", TRAIN)
@pytest.mark.parametrize("inference", INFERENCE)
def test_train_and_inference_configs_merge_alike(train, inference):
    theirs = jax_get_cfg()
    theirs.merge_from_file(os.path.join(configs_dir(), train))
    theirs.merge_from_file(os.path.join(configs_dir(), inference))
    assert merge_configs(train, inference).to_dict() == theirs.to_dict()


def test_overrides_and_unknown_keys():
    cfg = merge_configs(TRAIN[0], INFERENCE[0], ["SOLVER.STEPS", "(1, 2)", "TEST.EVAL_PERIOD", 5])
    assert cfg.SOLVER.STEPS == (1, 2) and cfg.TEST.EVAL_PERIOD == 5
    assert isinstance(get_cfg().SOLVER.STEPS, tuple)
    with pytest.raises(KeyError):
        merge_configs(TRAIN[0], "", ["MODEL.NOT_A_KEY", 1])
    frozen = get_cfg().freeze()
    with pytest.raises(AttributeError):
        frozen.SEED = 3
