"""The port's SubMPSD serving path against the JAX package end to end:
JAX ``LitPSD`` at the shipped SubMPSD.json widths, flax-initialised and
converted into the port, gives the same logits, plans and test outputs."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from waveformml_tpu.config import load_config as jax_load_config
from waveformml_tpu.datasets.hdf5_dataset import FileBlock as JaxFileBlock
from waveformml_tpu.engineering.tasks import LitPSD as JaxLitPSD
from waveformml_tpu_torch.config import load_config
from waveformml_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from waveformml_tpu_torch.datasets.hdf5_dataset import FileBlock
from waveformml_tpu_torch.datasets.synthetic import make_events
from waveformml_tpu_torch.detector import MAX_RANGE
from waveformml_tpu_torch.engineering.tasks import LitPSD
from waveformml_tpu_torch.inference.model import InferenceModel
from waveformml_tpu_torch.models.nets import SubMPSDNet

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "config", "examples", "SubMPSD.json")
N_EVENTS = 64


@pytest.fixture(scope="module")
def flagship():
    """Synthetic events, the JAX task with random weights and its prepared
    batch (plans included), and the flat flax variables."""
    rng = np.random.default_rng(7)
    ev = make_events(rng, N_EVENTS, 65, kind=1)
    coords = ev["coords"]
    feats = (ev["waveforms"] / MAX_RANGE).astype(np.float32)
    labels = rng.integers(0, 2, N_EVENTS).astype(np.int64)
    task = JaxLitPSD(jax_load_config(CONFIG))
    block = JaxFileBlock(coords, feats, labels, {})
    rb, eb = task.row_bucket(block), task.event_bucket(block)
    # flax init (which also records the plans prepare_block must ship), with
    # lecun-normal kernels; BatchNorm statistics and scales and the biases,
    # which init leaves trivial, are redrawn with numpy
    variables = task.init_variables(jax.random.PRNGKey(0),
                                    task.prepare_block(block, rb, eb))
    db = task.prepare_block(block, rb, eb)
    flat = {}
    for k, v in flatten_dict(jax.device_get(variables), sep="/").items():
        if k.endswith("/kernel"):
            value = np.asarray(v)
        elif k.endswith("/var"):
            value = rng.uniform(0.5, 2.0, size=v.shape)
        else:
            value = rng.normal(size=v.shape) * 0.1 + k.endswith("/scale")
        flat[k] = value.astype(np.float32)
    variables = unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                                for k, v in flat.items()})
    logits, _ = task.apply_model(variables, {k: jnp.asarray(v) for k, v in db.items()},
                                 train=False)
    return dict(coords=coords, feats=feats, labels=labels, task=task, db=db,
                flat=flat, variables=variables, logits=np.asarray(logits))


def test_jax_batch_takes_the_plan_path(flagship):
    for key in ("plan_k3", "plan_k1", "plan_site_take", "plan_site_ev", "plan_site_s"):
        assert key in flagship["db"], key


def test_logits_match_jax(flagship):
    model = InferenceModel(load_config(CONFIG), flax_to_state_dict(flagship["flat"]),
                           device="cpu")
    got = model(flagship["coords"], flagship["feats"])
    want = flagship["logits"][:N_EVENTS]
    assert got.shape == (N_EVENTS, 2) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    assert sorted(model.dispatch_phases) == ["fetch_s", "h2d_s", "host_prep_s",
                                             "launch_s"]
    assert all(v > 0 for v in model.dispatch_phases.values())


def test_prepare_block_plans_match_jax(flagship):
    task = LitPSD(load_config(CONFIG), device="cpu")
    block = FileBlock(flagship["coords"], flagship["feats"], flagship["labels"])
    db = task.prepare_block(block, task.row_bucket(block), task.event_bucket(block))
    want = flagship["db"]
    assert sorted(db) == sorted(want)
    for key, value in want.items():
        assert db[key].dtype == value.dtype, key
        np.testing.assert_array_equal(db[key], value, err_msg=key)


def test_site_capacity_only_grows(flagship):
    """After a crowded batch, a sparse one keeps the larger [S, MAX] shape,
    as the JAX task's high-water mark does."""
    task = LitPSD(load_config(CONFIG), device="cpu")
    # 20 events with a pulse each at site (0, 0): that site needs 32 slots
    n_crowd = 20
    crowd_coords = np.zeros((n_crowd, 3), np.int32)
    crowd_coords[:, 2] = np.arange(n_crowd)
    crowded = FileBlock(crowd_coords, flagship["feats"][:n_crowd],
                        flagship["labels"][:n_crowd])
    sparse = FileBlock(flagship["coords"][:3], flagship["feats"][:3],
                       flagship["labels"][:1])
    db_sparse_first = task.prepare_block(sparse, 256, 16)
    db_crowded = task.prepare_block(crowded, task.row_bucket(crowded),
                                    task.event_bucket(crowded))
    db_sparse = task.prepare_block(sparse, 256, 16)
    cap = db_crowded["plan_site_take"].shape[1]
    assert db_sparse_first["plan_site_take"].shape[1] == 8 < cap
    assert db_sparse["plan_site_take"].shape[1] == cap
    np.testing.assert_array_equal(db_sparse["plan_site_take"][:, :8],
                                  db_sparse_first["plan_site_take"])


def test_test_outputs_and_accuracy_match_jax(flagship):
    task = LitPSD(load_config(CONFIG), device="cpu")
    task.model.load_state_dict(flax_to_state_dict(flagship["flat"]))
    db = task.to_device(flagship["db"])
    outputs = task.apply_model(db)
    got = task.test_outputs(outputs, db)
    jdb = {k: jnp.asarray(v) for k, v in flagship["db"].items()}
    jout = jnp.asarray(flagship["logits"])
    want = flagship["task"].test_outputs(jout, jdb)
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["logprob"].numpy(), np.asarray(want["logprob"]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(got["pred"].numpy(), np.asarray(want["pred"]))
    sums = task.accuracy_sums(outputs, db)
    _, _, jsums = flagship["task"].loss_and_metrics(jout, jdb)
    assert float(sums["accuracy_sum"]) == float(jsums["accuracy_sum"])
    assert float(sums["accuracy_count"]) == float(jsums["accuracy_count"]) == N_EVENTS


def test_converter_round_trips(flagship):
    state = flax_to_state_dict(flagship["flat"])
    model = SubMPSDNet(load_config(CONFIG))
    assert sorted(state) == sorted(model.state_dict())
    for key, value in model.state_dict().items():
        assert state[key].shape == value.shape, key
    back = state_dict_to_flax(state)
    assert sorted(back) == sorted(flagship["flat"])
    for key, value in flagship["flat"].items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)


def test_entry_point_needs_cuda_without_a_device(flagship, monkeypatch, tmp_path):
    state = flax_to_state_dict(flagship["flat"])
    path = tmp_path / "submpsd.pt"
    torch.save(state, path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceModel(load_config(CONFIG), path)
    # a saved state_dict serves the same logits as the in-memory one
    got = InferenceModel(load_config(CONFIG), path, device="cpu")(
        flagship["coords"], flagship["feats"])
    np.testing.assert_allclose(got, flagship["logits"][:N_EVENTS], rtol=1e-4, atol=1e-5)
