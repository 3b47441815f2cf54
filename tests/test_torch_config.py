"""The port's ``validate_config`` and ``load_config`` against the JAX
package's: the same filled config for every shipped example, the same
error for the same missing required key, and the template's rules (atomic
dict defaults, the optimizer and scheduler parameter defaults only for
their own class, required-key markers) alike."""
import copy
import glob
import json
import os

import pytest

from waveformml_tpu_torch.config import Config, load_config, validate_config

EXAMPLES = sorted(glob.glob(os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "config", "examples", "*.json")))


def _both(d, requirements=None):
    """(JAX result, port result): each the filled dict, or the raised
    exception's type and message."""
    from waveformml_tpu.config import Config as JaxConfig
    from waveformml_tpu.config import validate_config as jax_validate

    out = []
    for cls, fn in ((JaxConfig, jax_validate), (Config, validate_config)):
        try:
            out.append(fn(cls(copy.deepcopy(d)), copy.deepcopy(requirements)).to_dict())
        except ValueError as e:
            out.append((type(e).__name__, str(e)))
    return out


def test_thirteen_examples_are_shipped():
    assert len(EXAMPLES) == 13


@pytest.mark.parametrize("path", EXAMPLES, ids=os.path.basename)
def test_examples_validate_alike(path):
    from waveformml_tpu.config import load_config as jax_load_config

    with open(path) as f:
        raw = json.load(f)
    jax_result, port_result = _both(raw)
    assert port_result == jax_result
    if isinstance(port_result, dict):
        assert load_config(path).to_dict() == jax_load_config(path).to_dict()
        assert load_config(path, validate=False).to_dict() == raw


@pytest.mark.parametrize("missing", ["system_config/type_names", "dataset_config/paths",
                                     "dataset_config/n_train", "system_config/n_samples"])
def test_same_missing_required_key_raises(missing):
    with open(os.path.join(os.path.dirname(EXAMPLES[0]), "SubMPSD.json")) as f:
        d = json.load(f)
    section, key = missing.split("/")
    del d[section][key]
    jax_result, port_result = _both(d)
    assert port_result == jax_result == ("ValueError", f"required config key missing: {missing}")


@pytest.mark.parametrize("optimize_config", [
    {"optimizer_class": "optim.Adam"},
    {"optimizer_class": "SGD"},
    {"optimizer_class": "optim.SGD", "optimizer_params": {}},
    {"scheduler_class": "lr_scheduler.StepLR"},
    {"scheduler_class": "ExponentialLR"},
    {},
], ids=["adam_gets_no_sgd_defaults", "sgd_alias_gets_them", "present_dict_is_atomic",
        "steplr_gets_no_gamma", "exponential_alias_gets_gamma", "all_defaults"])
def test_optimizer_and_scheduler_defaults_alike(optimize_config):
    d = {"system_config": {"type_names": ["a"], "n_samples": 8},
         "dataset_config": {"paths": ["a"], "n_train": 1, "n_validate": 1},
         "optimize_config": optimize_config}
    jax_result, port_result = _both(d)
    assert port_result == jax_result
    assert isinstance(port_result, dict)


def test_custom_requirements_alike():
    req = {"run_config": {"exp_name": "custom", "seed": 7, "tags": [""]},
           "net_config": {"hparams": {"width": 4}}}
    d = {"run_config": {"tags": ["x"]}, "net_config": {}}
    jax_result, port_result = _both(d, req)
    assert port_result == jax_result
    assert port_result["run_config"] == {"tags": ["x"], "exp_name": "custom", "seed": 7}
    jax_result, port_result = _both({"run_config": {}}, req)
    assert port_result == jax_result == ("ValueError",
                                         "required config key missing: run_config/tags")


@pytest.mark.parametrize("name", ["GEP", "IoniClassifierCNN", "DensePSD", "OPs3ns_SCNet",
                                  "SingleWaveformTCN", "SingleWaveformRNN", "SCNet3D"])
def test_sparse_net_configs_validate_and_resolve(name):
    """The configs of the sparse nets, the waveform nets and the 3D net
    validate as the JAX package's do, and
    each class they name (task, net, criterion, optimizer, scheduler,
    dataset, the DSL's layers) resolves in the port's registry."""
    from waveformml_tpu_torch.models.algorithm import split_algorithm
    from waveformml_tpu_torch.registry import retrieve_class

    path = os.path.join(os.path.dirname(EXAMPLES[0]), f"{name}.json")
    with open(path) as f:
        raw = json.load(f)
    jax_result, port_result = _both(raw)
    assert isinstance(port_result, dict) and port_result == jax_result
    cfg = load_config(path)
    names = [cfg.run_config.run_class, cfg.net_config.net_class,
             cfg.net_config.criterion_class, cfg.optimize_config.optimizer_class,
             cfg.optimize_config.scheduler_class, cfg.dataset_config.dataset_class]
    algorithm = raw["net_config"].get("algorithm")
    if algorithm:
        names += [item for section in split_algorithm(algorithm) for item in section
                  if isinstance(item, str) and item != "spconv.ToDense"]
        names.append("spconv.ToDense")
    for n in names:
        assert retrieve_class(n) is not None, n
