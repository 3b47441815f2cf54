"""The port's config ``algorithm`` DSL against the JAX package's:
``split_algorithm``, ``dsl_to_row_specs``, ``build_sparse_instances`` and
``create_class_instances`` on the DSL lists of ``tests/test_models.py`` and
the shipped configs; ``ModelValidation`` on good and bad lists (the same
outcome, the same message); each DSL layer of ``nn/layers.py`` from the
same weights, in train and eval mode; ``SCNet`` on the grid (strided and
SparseConvNet convs) and in row space behind a ``nn.Conv1d`` waveform
section; the 3D paths, which build and run; and ``main --validate``."""
import copy
import glob
import json
import os
import re
import zlib

import numpy as np
import pytest
import torch

from waveformml_tpu_torch.config import Config, load_config, to_dict
from waveformml_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from waveformml_tpu_torch.models import algorithm
from waveformml_tpu_torch.registry import registry
from waveformml_tpu_torch.utils.model_validation import ModelValidation

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "config", "examples")
NX, NY = 14, 11
N_SAMPLES = 8
S2 = 2 * N_SAMPLES

#: DSL lists of tests/test_models.py, the shipped DSL configs' and a few
#: more: a Conv1d section straight into the head, the kwargs form, strided,
#: even-kernel and SparseConvNet convs, translated activations
DSLS = {
    "scnet": ["spconv.SubMConv2d", [S2, 8, 3, 1, 1, 1], "nn.BatchNorm1d", [8], "nn.ReLU",
              "spconv.ToDense", "nn.Linear", [8 * NX * NY, 16], "nn.ReLU",
              "nn.Linear", [16, 3]],
    "flatten": ["spconv.SubMConv2d", [S2, 8, 3, 1, 1, 1], "spconv.ToDense", "nn.Flatten", [],
                "nn.Linear", [8 * NX * NY, 3]],
    "waveform": ["nn.Conv1d", [2, 4, 3, 1, 1, 1], "nn.ReLU", "spconv.SubMConv2d",
                 [4 * N_SAMPLES, 8, 3, 1, 1, 1], "nn.ReLU", "spconv.ToDense",
                 "nn.Linear", [8 * NX * NY, 3]],
    "conv2d_pool": ["nn.Conv2d", [S2, 8, 3, 1, 1, 1], "nn.MaxPool2d", [2], "nn.Flatten", [],
                    "nn.Linear", [7 * 5 * 8, 3]],
    "conv1d_head": ["nn.Conv1d", [2, 3, 3, 1, 1, 1], "nn.ReLU", "nn.Linear",
                    [3 * N_SAMPLES, 2]],
    "kwargs": ["spconv.SubMConv2d", {"in_channels": S2, "out_channels": 4, "kernel_size": 3},
               "nn.BatchNorm1d", {"num_features": 4}, "nn.ReLU", "nn.Dropout", {"p": 0.25},
               "spconv.ToDense", "nn.Linear", [4 * NX * NY, 2]],
    "grid": ["spconv.SparseConv2d", [S2, 8, 3, 2, 1, 1], "nn.BatchNorm1d", [8], "nn.ReLU",
             "sparseconvnet.SubmanifoldConvolution", [2, 8, 4, 3, False],
             "nn.LeakyReLU", [0.2], "nn.Tanh", "spconv.ToDense",
             "nn.Linear", [4 * 7 * 6, 3]],
    "scn_conv": ["sparseconvnet.Convolution", [2, S2, 6, 3, 1, True], "nn.Sigmoid",
                 "spconv.ToDense", "nn.Linear", [6 * 12 * 9, 2]],
    "even_k": ["spconv.SubMConv2d", [S2, 4, 2, 1, 0, 1], "spconv.ToDense",
               "nn.Linear", [4 * NX * NY, 2]],
}


def _shipped_dsls():
    out = {}
    for path in sorted(glob.glob(os.path.join(EXAMPLES, "*.json"))):
        with open(path) as f:
            nc = json.load(f).get("net_config", {})
        if isinstance(nc.get("algorithm"), list):
            out[os.path.basename(path)[:-5]] = nc["algorithm"]
    return out


SHIPPED = _shipped_dsls()
ALL_DSLS = {**DSLS, **SHIPPED}


def test_the_shipped_dsl_configs():
    assert sorted(SHIPPED) == ["OPs3ns_SCNet", "SCNet3D"]


@pytest.mark.parametrize("name", sorted(ALL_DSLS))
def test_split_and_row_specs_match_jax(name):
    from waveformml_tpu.models import algorithm as jalg

    dsl = copy.deepcopy(ALL_DSLS[name])
    got, want = algorithm.split_algorithm(dsl), jalg.split_algorithm(dsl)
    assert got == want
    sparse = got[1]
    assert algorithm.dsl_to_row_specs(sparse) == jalg.dsl_to_row_specs(sparse)
    if name in ("scnet", "OPs3ns_SCNet", "kwargs"):
        assert algorithm.dsl_to_row_specs(sparse) is not None
    if name in ("grid", "scn_conv", "even_k"):
        assert algorithm.dsl_to_row_specs(sparse) is None


def test_row_specs_of_ops3ns():
    _, sparse, linear = algorithm.split_algorithm(SHIPPED["OPs3ns_SCNet"])
    assert algorithm.dsl_to_row_specs(sparse) == [
        ("subm", 130, 32, 3, 1, "subm3"), ("bn", 32), ("relu",),
        ("subm", 32, 8, 3, 1, "subm3"), ("relu",), ("todense",)]
    assert linear[1] == [1232, 32]
    # a Config-object argument reads as the kwargs form
    cfg = Config({"in_channels": 2, "out_channels": 4, "kernel_size": 3, "stride": 2})
    assert algorithm.dsl_to_row_specs(["spconv.SubMConv2d", cfg]) is None


def _names(instances):
    return [type(x).__name__ for x in instances]


@pytest.mark.parametrize("name", ["scnet", "flatten", "grid", "scn_conv", "kwargs", "even_k",
                                  "OPs3ns_SCNet"])
def test_build_sparse_instances_match_jax(name):
    from waveformml_tpu.models import algorithm as jalg

    _, sparse, _ = algorithm.split_algorithm(ALL_DSLS[name])
    got = algorithm.build_sparse_instances(copy.deepcopy(sparse))
    want = jalg.build_sparse_instances(copy.deepcopy(sparse))
    assert _names(got) == _names(want)
    for g, w in zip(got, want):
        if hasattr(w, "rate") and name != "kwargs":
            assert g.rate == w.rate
        if getattr(w, "num_features", None) is not None:
            assert g.weight.shape == (w.num_features,)


def test_sparse_translations_read_keyword_arguments():
    """BatchNorm1d(num_features=c), Dropout(p=r) and LeakyReLU(
    negative_slope=s) in the sparse section: the width, rate and slope
    asked for (the JAX package's translations read positional arguments
    only)."""
    got = algorithm.build_sparse_instances(algorithm.split_algorithm(DSLS["kwargs"])[1])
    assert _names(got) == ["SubMConv2d", "MaskedBatchNorm", "SparseReLU", "SparseDropout",
                           "ToDense"]
    assert got[1].weight.shape == (4,) and got[3].rate == 0.25
    leaky = algorithm.build_sparse_instances(["nn.LeakyReLU", {"negative_slope": 0.3}])[0]
    x = torch.full((1, 1, 2, 2), -1.0)
    from waveformml_tpu_torch.ops.sparse_conv import SparseGrid

    occ = torch.ones(1, 2, 2, dtype=torch.bool)
    assert torch.allclose(leaky(SparseGrid(x, occ)).features, torch.full_like(x, -0.3))


@pytest.mark.parametrize("name", ["scnet", "waveform", "conv2d_pool", "conv1d_head", "kwargs"])
def test_create_class_instances_match_jax(name):
    """The waveform and linear sections (the waveform section with the
    masked BatchNorm translation) build the same classes."""
    from waveformml_tpu.models import algorithm as jalg
    from waveformml_tpu.models.nets import _WAVEFORM_TRANSLATIONS as JAX_WF
    from waveformml_tpu.registry import registry as jregistry
    from waveformml_tpu_torch.models.nets import _WAVEFORM_TRANSLATIONS

    wf, sparse, linear = algorithm.split_algorithm(ALL_DSLS[name])
    for section, ours, theirs in ((wf, _WAVEFORM_TRANSLATIONS, JAX_WF),
                                  (linear, None, None)):
        got = registry.create_class_instances(copy.deepcopy(section), ours)
        want = jregistry.create_class_instances(copy.deepcopy(section), theirs)
        assert _names(got) == _names(want)
    if name == "conv2d_pool":
        got = registry.create_class_instances(copy.deepcopy(sparse))
        want = jregistry.create_class_instances(copy.deepcopy(sparse))
        assert _names(got) == _names(want) == ["Conv2d", "MaxPool2d", "Flatten"]
    del jalg


def test_create_class_instances_argument_forms():
    spec = ["nn.Linear", [3, 2], "nn.ReLU", "nn.Dropout", {"rate": 0.25},
            "nn.Linear", Config({"in_features": 2, "out_features": 1}), "nn.Identity"]
    layers = registry.create_class_instances(spec)
    assert _names(layers) == ["Linear", "ReLU", "Dropout", "Linear", "Identity"]
    assert layers[0].dense.weight.shape == (2, 3) and layers[2].rate == 0.25
    assert layers[3].dense.weight.shape == (1, 2)
    marker = object()
    assert registry.create_class_instances(["nn.ReLU"], {"nn.ReLU": lambda: marker}) == [marker]
    with pytest.raises(ValueError, match="no preceding class"):
        registry.create_class_instances([[3, 2]])
    with pytest.raises(ValueError, match="no preceding class"):
        registry.create_class_instances([{"in_features": 3}])
    with pytest.raises(ValueError, match="unexpected entry"):
        registry.create_class_instances(["nn.ReLU", 3])
    with pytest.raises(KeyError):
        registry.create_class_instances(["nn.NoSuchLayer"])


# -- ModelValidation ---------------------------------------------------------------

def _validation_config(dsl, net_type="2DConvolution", n_samples=N_SAMPLES):
    return {"system_config": {"n_samples": n_samples},
            "net_config": {"net_type": net_type, "algorithm": copy.deepcopy(dsl)}}


def _bad(dsl, index, value):
    out = copy.deepcopy(dsl)
    out[index] = value
    return out


def _with_flatten(dsl):
    """The list with an ``nn.Flatten`` after each ``ToDense``: what the
    JAX package's validation needs to read ToDense as the nets do."""
    out = []
    for item in dsl:
        out.append(item)
        if isinstance(item, str) and item.endswith("ToDense"):
            out += ["nn.Flatten", []]
    return out


OPS = SHIPPED["OPs3ns_SCNet"]
VALIDATIONS = {
    **{k: _validation_config(v) for k, v in DSLS.items() if k not in ("kwargs",)},
    "OPs3ns_SCNet": _validation_config(OPS, n_samples=65),
    "SCNet3D": _validation_config(SHIPPED["SCNet3D"], "3DConvolution", n_samples=16),
    "bad_head": _validation_config(_bad(OPS, 10, [1231, 32]), n_samples=65),
    "bad_second_head": _validation_config(_bad(OPS, 13, [31, 2]), n_samples=65),
    "bad_channels": _validation_config(_bad(OPS, 6, [31, 8, 3, 1, 1, 1]), n_samples=65),
    "bad_samples": _validation_config(OPS, n_samples=64),
    "bad_linear": _validation_config(["nn.Linear", [999, 3]]),
    "bad_pool": _validation_config(_bad(DSLS["conv2d_pool"], 7, [14 * 11 * 8, 3])),
    "bad_dim": _validation_config(OPS, "3DConvolution", n_samples=65),
    "bad_net_type": _validation_config(OPS, "1DConvolution"),
    "hparams": {"system_config": {"n_samples": 8},
                "net_config": {"net_type": "2DConvolution", "hparams": {"n_conv": 2}}},
}
#: lists the validation passes (it reads a waveform section's widths as
#: lengths, a SubM conv of SparseConvNet as unpadded and an even SubM
#: kernel's padding as given, as the JAX package's does)
VALID = {"OPs3ns_SCNet", "SCNet3D", "scnet", "flatten", "conv2d_pool", "scn_conv", "hparams"}


def _outcome(cls, validation, d):
    try:
        validation.validate(cls(copy.deepcopy(d)))
        return None
    except IOError as e:
        # the layer names of a message: the JAX run reads ToDense's flatten
        # at the nn.Flatten put after it
        return re.sub(r"between layers? \S+ and", "between layers and", str(e))


@pytest.mark.parametrize("name", sorted(VALIDATIONS))
def test_model_validation_matches_jax(name):
    """The same outcome on good and bad lists: no error, or an IOError with
    the same message, the JAX package's validation given an ``nn.Flatten``
    after each ``ToDense`` (the port's flattens there itself)."""
    from waveformml_tpu.config import Config as JaxConfig
    from waveformml_tpu.utils.model_validation import ModelValidation as JaxValidation

    d = VALIDATIONS[name]
    jd = copy.deepcopy(d)
    if "algorithm" in jd["net_config"]:
        jd["net_config"]["algorithm"] = _with_flatten(jd["net_config"]["algorithm"])
    got = _outcome(Config, ModelValidation, d)
    assert got == _outcome(JaxConfig, JaxValidation, jd)
    assert (got is None) == (name in VALID), got
    assert _outcome(Config, ModelValidation, jd) == got


def test_validation_flattens_at_todense():
    """The shipped DSL configs pass the port's validation as they are; the
    JAX package's rejects them (it keeps ToDense's channel width)."""
    from waveformml_tpu.config import Config as JaxConfig
    from waveformml_tpu.utils.model_validation import ModelValidation as JaxValidation

    for name, want in (("OPs3ns_SCNet", "to be 8, got 1232"), ("SCNet3D", "to be 8, got 19712")):
        d = VALIDATIONS[name]
        assert _outcome(Config, ModelValidation, d) is None
        assert want in _outcome(JaxConfig, JaxValidation, d)


def _cli_config(tmp_path, dsl):
    d = to_dict(load_config(os.path.join(EXAMPLES, "OPs3ns_SCNet.json")))
    d["net_config"]["algorithm"] = dsl
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(d))
    return str(path)


def test_main_validate_runs_before_training(tmp_path, monkeypatch):
    """``main --validate``: a good DSL passes and training starts; a wrong
    one (Linear 1232 → 1231 in the head) raises before anything is
    built."""
    from waveformml_tpu_torch import main as cli

    runs = []
    monkeypatch.setattr(cli, "choose_data_module", lambda config: None)
    monkeypatch.setattr(cli, "run", lambda config, args, dm: runs.append(args.validate))
    good = SHIPPED["OPs3ns_SCNet"]
    assert cli.main([_cli_config(tmp_path, good), "--validate", "--device", "cpu"]) == 0
    assert runs == [True]
    bad = _bad(good, 10, [1231, 32])
    with pytest.raises(IOError, match="Expecting the input dimensions to be 1232, got 1231"):
        cli.main([_cli_config(tmp_path, bad), "--validate", "--device", "cpu"])
    assert runs == [True]
    # without --validate the wrong head is found only when the net is built
    assert cli.main([_cli_config(tmp_path, bad), "--device", "cpu"]) == 0
    assert runs == [True, False]


# -- the DSL's layers against flax -------------------------------------------------

LAYERS = [
    ("nn.Linear", [6, 4], (5, 6)),
    ("nn.Conv1d", [3, 4, 3, 2, 1, 2], (5, 3, 17)),
    ("nn.Conv1d", [4, 6, 3, 1, 1, 1, 2], (5, 4, 9)),
    ("nn.Conv2d", [3, 5, [3, 2], 1, [1, 0], 1], (2, 3, 7, 6)),
    ("nn.ReLU", [], (4, 3, 5)),
    ("nn.SELU", [], (4, 3, 5)),
    ("nn.GELU", [], (4, 3, 5)),
    ("nn.Tanh", [], (4, 3, 5)),
    ("nn.Sigmoid", [], (4, 3, 5)),
    ("nn.Identity", [], (4, 3, 5)),
    ("nn.LeakyReLU", [0.2], (4, 3, 5)),
    ("nn.Softmax", [1], (4, 3, 5)),
    ("nn.Softmax", [-1], (4, 3, 5)),
    ("nn.LogSoftmax", [2], (4, 3, 5)),
    ("nn.Flatten", [], (4, 3, 5)),
    ("nn.BatchNorm1d", [3], (6, 3, 5)),
    ("nn.BatchNorm1d", [5], (6, 5)),
    ("nn.BatchNorm2d", [3], (2, 3, 4, 5)),
    ("nn.LayerNorm", [5], (4, 3, 5)),
    ("nn.LayerNorm", [6], (4, 6)),
    ("nn.MaxPool1d", [2], (4, 3, 9)),
    ("nn.AvgPool1d", [3, 2], (4, 3, 9)),
    ("nn.MaxPool2d", [2], (2, 3, 7, 5)),
    ("nn.AvgPool2d", [[2, 1]], (2, 3, 7, 5)),
]


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("name,args,shape", LAYERS, ids=lambda v: str(v))
def test_layer_matches_flax(name, args, shape, train):
    """The port's layer (channels first) against the JAX package's
    (channels last) on the same input and weights, parameters drawn at
    random and carried by ``convert.py``; a BatchNorm's running statistics
    after a train-mode call, too."""
    import jax
    import jax.numpy as jnp

    from waveformml_tpu.registry import registry as jregistry

    rng = np.random.default_rng(zlib.crc32(f"{name}{args}{shape}".encode()))
    x = rng.normal(size=shape).astype(np.float32)
    # Flatten reads the array as it lies (after ToDense: [B, C, H, W] in both)
    x_last = np.moveaxis(x, 1, -1) if x.ndim > 2 and name != "nn.Flatten" else x
    jlayer = jregistry.retrieve_class(name)(*args)
    variables = jlayer.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x_last))
    from flax.traverse_util import flatten_dict, unflatten_dict

    flat = {k: (rng.normal(size=np.shape(v)) * 0.5
                + (k.endswith("scale") or k.endswith("var"))).astype(np.float32)
            for k, v in flatten_dict(jax.device_get(variables), sep="/").items()}
    variables = unflatten_dict({tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})
    if train:
        want, updates = jlayer.apply(variables, jnp.asarray(x_last), train=True,
                                     mutable=["batch_stats"])
    else:
        want, updates = jlayer.apply(variables, jnp.asarray(x_last), train=False), {}
    want = np.asarray(want)
    if want.ndim > 2 and name != "nn.Flatten":
        want = np.moveaxis(want, -1, 1)
    layer = registry.retrieve_class(name)(*args)
    state = flax_to_state_dict(flat)
    assert sorted(state) == sorted(layer.state_dict())
    layer.load_state_dict(state)
    layer.train(train)
    with torch.no_grad():
        got = layer(torch.from_numpy(x), None).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    back = state_dict_to_flax(layer.state_dict())
    if not train:
        assert sorted(back) == sorted(flat)
        for k, v in flat.items():
            np.testing.assert_array_equal(back[k], v, err_msg=k)
    for k, v in flatten_dict(jax.device_get(dict(updates)), sep="/").items():
        np.testing.assert_allclose(back[k], np.asarray(v), rtol=1e-5, atol=1e-6, err_msg=k)


def test_dropout_layers_draw_from_the_generator():
    layer = registry.retrieve_class("nn.Dropout")(0.5)
    x = torch.ones(64, 8)
    with pytest.raises(ValueError, match="Generator"):
        layer(x)
    y = layer(x, torch.Generator().manual_seed(0))
    assert set(torch.unique(y).tolist()) == {0.0, 2.0}
    assert torch.equal(y, layer(x, torch.Generator().manual_seed(0)))
    layer.eval()
    assert torch.equal(layer(x), x)


# -- SCNet ---------------------------------------------------------------------------

def _batch_pair(rng, n_feat, n_events=4, n_rows=48):
    import jax.numpy as jnp

    from waveformml_tpu.ops.sparse import SparseBatch as JaxBatch
    from waveformml_tpu_torch.ops.row_conv import host_neighbor_plan
    from waveformml_tpu_torch.ops.sparse import SparseBatch, pad_sparse

    rows = [[s % NX, s // NX, e] for e in range(n_events)
            for s in rng.choice(NX * NY, size=rng.integers(1, 6), replace=False)]
    rows += [[0, 0, 0], [NX - 1, NY - 1, 1]]
    coords = np.asarray(rows, np.int32)
    feats = rng.normal(size=(coords.shape[0], n_feat)).astype(np.float32)
    c, f, m = pad_sparse(coords, feats, n_rows)
    plan = host_neighbor_plan(c, m, n_events, 3)
    jb = JaxBatch(jnp.asarray(c), jnp.asarray(f), jnp.asarray(m), n_events,
                  plans={"k3": jnp.asarray(plan)})
    pb = SparseBatch(torch.from_numpy(c), torch.from_numpy(f), torch.from_numpy(m), n_events,
                     plans={"k3": torch.from_numpy(plan)})
    return jb, pb


@pytest.mark.parametrize("name", ["grid", "scn_conv", "waveform", "scnet", "flatten"])
def test_scnet_matches_jax(name):
    """SCNet on the grid (a strided sparse conv, SparseConvNet convs, the
    translated activations) and in row space, behind a ``nn.Conv1d``
    waveform section whose rows carry the batch's plan; eval and train
    mode (masked BatchNorm statistics) from the same weights."""
    import jax
    from flax.traverse_util import flatten_dict

    from waveformml_tpu.config import Config as JaxConfig
    from waveformml_tpu.models.nets import SCNet as JaxSCNet
    from waveformml_tpu_torch.models.nets import SCNet

    d = {"system_config": {"n_samples": N_SAMPLES, "n_type": 3},
         "net_config": {"net_type": "2DConvolution", "algorithm": copy.deepcopy(DSLS[name])}}
    rng = np.random.default_rng(5)
    jb, pb = _batch_pair(rng, S2)
    jnet = JaxSCNet(JaxConfig(copy.deepcopy(d)))
    variables = jnet.init({"params": jax.random.PRNGKey(1)}, jb)
    flat = {k: (np.asarray(v) if k.endswith("kernel") else
                (rng.normal(size=np.shape(v)) * 0.2 + (k.endswith("scale") or
                                                       k.endswith("var")))).astype(np.float32)
            for k, v in flatten_dict(jax.device_get(variables), sep="/").items()}
    from flax.traverse_util import unflatten_dict

    variables = unflatten_dict({tuple(k.split("/")): v for k, v in flat.items()})
    net = SCNet(Config(copy.deepcopy(d)))
    assert net.row_path == (name in ("waveform", "scnet"))
    net.load_state_dict(flax_to_state_dict(flat))
    for train in (False, True):
        if train:
            want, _ = jnet.apply(variables, jb, train=True, mutable=["batch_stats"])
        else:
            want = jnet.apply(variables, jb, train=False)
        net.train(train)
        with torch.no_grad():
            got = net(pb).numpy()
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    if net.row_path:
        # the plan the batch carries is the one the convs read
        bad = dict(pb.plans, k3=torch.where(pb.mask[:, None], -1, pb.plans["k3"]))
        net.eval()
        with torch.no_grad():
            sab = net(type(pb)(pb.coords, pb.feats, pb.mask, pb.n_events, plans=bad))
        assert not np.allclose(sab.numpy(), got)


def test_3d_paths_raise():
    """The 3D paths that raised until they were ported now build and run:
    SCNet over SCNet3D.json (its sparse section on the [B, 8, 14, 11, 16]
    grid, the flatten 19712 wide) and a 3D row stack ``DSLSpecNet(n_t=16)``
    (its plan ``k3t16``, the K×K×K window's 27 taps)."""
    from waveformml_tpu_torch.datasets.synthetic import labelled_block_3d
    from waveformml_tpu_torch.engineering.tasks import LitPSD
    from waveformml_tpu_torch.models.nets import SCNet
    from waveformml_tpu_torch.models.sparse_blocks import DSLSpecNet

    cfg = load_config(os.path.join(EXAMPLES, "SCNet3D.json"))
    task = LitPSD(cfg, device="cpu")
    assert isinstance(task.model, SCNet) and task.model.ndim == 3 and not task.model.row_path
    assert task.model.n_linear == 19712 and task.model.plan_requirements() == set()
    block = labelled_block_3d(np.random.default_rng(2), 6, 16)
    db = task.to_device(task.prepare_block(block, task.row_bucket(block),
                                           task.event_bucket(block)))
    out = task.apply_model(db)
    assert out.shape == (16, 2) and bool(torch.isfinite(out).all())
    net = DSLSpecNet([("subm", 2, 8, 3, 1, "subm3")], n_t=16)
    assert net.plan_requirements() == {"k3t16"} and net.l0.weight.shape == (27, 2, 8)
