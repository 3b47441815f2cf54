"""The port's InferenceModel against the JAX package's, both loading one
checkpoint written by the JAX Trainer (orbax on the JAX side, its weights
converted for the port): int16 features through an on-device
``preprocess`` and a ``postprocess``, the un-padding of ``output_unit``,
the packed copy of a prepared batch, and double-buffered dispatch. On the
card (the ``cuda`` marker), the CUDA-graph path against the eager forward."""
import copy
import logging

import numpy as np
import pytest
import torch

from waveformml_tpu_torch.config import Config
from waveformml_tpu_torch.convert import flax_to_state_dict
from waveformml_tpu_torch.datasets.hdf5_dataset import FileBlock
from waveformml_tpu_torch.datasets.synthetic import make_events
from waveformml_tpu_torch.detector import MAX_RANGE, NX, NY
from waveformml_tpu_torch.engineering.base import pack_db, unpack_db
from waveformml_tpu_torch.engineering.tasks import LitPSD
from waveformml_tpu_torch.inference.model import InferenceModel

RTOL, ATOL = 1e-4, 1e-5        # tests/test_torch_slice.py's logit tolerance
N_SAMPLES = 8

CFG = {
    "run_config": {"exp_name": "t", "run_class": "LitPSD", "imports": []},
    "system_config": {"model_name": "t", "n_samples": N_SAMPLES, "n_type": 2,
                      "type_names": ["a", "b"], "half_precision": 0},
    "net_config": {"criterion_class": "CrossEntropyLoss", "criterion_params": [],
                   "imports": [], "net_class": "SubMPSDNet", "net_type": "2DConvolution",
                   "hparams": {"out_planes": 8, "n_lin": 2,
                               "conv_params": {"kernel_size": 3, "n_conv": 2, "n_point": 1,
                                               "conv_position": 1, "version": 2}}},
    "optimize_config": {"total_epoch": 1, "lr": 0.01, "imports": [],
                        "optimizer_class": "optim.SGD", "optimizer_params": {}},
    "dataset_config": {"mode": "path", "imports": [], "paths": ["a", "b"],
                       "dataset_class": "PulseDataset2D", "dataset_params": {}},
}


def _adc_chunk(rng, n_events):
    """Synthetic events with raw int16 ADC waveforms [N, 2·N_SAMPLES]."""
    ev = make_events(rng, n_events, N_SAMPLES, kind=1)
    return ev["coords"], np.rint(ev["waveforms"]).astype(np.int16)


def _square_chunk(rng):
    """150 events over 200 rows (50 events with two rows): row bucket and
    event bucket are both 256."""
    coords = []
    for e in range(150):
        sites = rng.choice(NX * NY, size=2 if e < 50 else 1, replace=False)
        coords += [[s % NX, s // NX, e] for s in sites]
    coords = np.asarray(coords, np.int32)
    vals = rng.uniform(0, MAX_RANGE, size=(coords.shape[0], 2 * N_SAMPLES))
    return coords, np.rint(vals).astype(np.int16)


def jax_pre(coords, feats, mask):
    return feats.astype("float32") / MAX_RANGE


def port_pre(coords, feats, mask):
    return feats.float() / MAX_RANGE


def jax_post(outputs, coords, mask):
    """Per-event log-probabilities gathered to rows, padding rows zero."""
    import jax

    rows = jax.nn.log_softmax(outputs, axis=-1)[coords[:, -1]]
    return rows * mask[:, None]


def port_post(outputs, coords, mask):
    rows = torch.log_softmax(outputs, dim=-1)[coords[:, -1].long()]
    return rows * mask[:, None]


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A JAX Trainer's orbax checkpoint of the narrow SubMPSD, its random
    init with the biases and BatchNorm statistics and scales redrawn; and
    the same weights as a port state_dict."""
    import jax
    import jax.numpy as jnp
    from flax.traverse_util import flatten_dict, unflatten_dict

    from waveformml_tpu.config import Config as JaxConfig
    from waveformml_tpu.engineering.tasks import LitPSD as JaxLitPSD
    from waveformml_tpu.engineering.trainer import Trainer as JaxTrainer
    from waveformml_tpu.parallel.mesh import make_mesh

    rng = np.random.default_rng(21)
    coords, vals = _adc_chunk(rng, 20)
    jcfg = JaxConfig(copy.deepcopy(CFG))
    jt = JaxTrainer(jcfg, JaxLitPSD(jcfg), mesh=make_mesh(jax.devices()[:1]), callbacks=[])
    jt._ensure_state(FileBlock(coords, (vals / MAX_RANGE).astype(np.float32),
                               np.zeros(20, np.int64)))
    flat = {}
    for k, v in flatten_dict(jax.device_get({"params": jt.state.params,
                                             "batch_stats": jt.state.batch_stats}),
                             sep="/").items():
        if k.endswith("/kernel"):
            value = np.asarray(v)
        elif k.endswith("/var"):
            value = rng.uniform(0.5, 2.0, size=v.shape)
        else:
            value = rng.normal(size=v.shape) * 0.1 + k.endswith("/scale")
        flat[k] = value.astype(np.float32)
    tree = unflatten_dict({tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})
    jt.state.params, jt.state.batch_stats = tree["params"], tree["batch_stats"]
    path = str(tmp_path_factory.mktemp("jax") / "epoch=0-val_loss=0.50.ckpt")
    jt.save_checkpoint(path)
    return dict(path=path, jcfg=jcfg, state=flax_to_state_dict(flat))


def _models(checkpoint, **kwargs):
    from waveformml_tpu.inference.model import InferenceModel as JaxInferenceModel

    jkw = {k: (jax_pre if v is port_pre else jax_post if v is port_post else v)
           for k, v in kwargs.items()}
    return (InferenceModel(Config(copy.deepcopy(CFG)), checkpoint["state"], device="cpu",
                           **kwargs),
            JaxInferenceModel(checkpoint["jcfg"], checkpoint["path"], **jkw))


def test_int16_preprocess_and_postprocess_match_jax(checkpoint):
    """int16 ADC counts ship as they are and are scaled on the device;
    the postprocess gathers per-event log-probabilities to rows."""
    coords, vals = _adc_chunk(np.random.default_rng(1), 40)
    model, jmodel = _models(checkpoint, preprocess=port_pre, postprocess=port_post,
                            output_unit="row")
    got, want = model(coords, vals), np.asarray(jmodel(coords, vals))
    assert got.shape == want.shape == (coords.shape[0], 2)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # the same as float32 features scaled on the host, post-processed after
    plain, _ = _models(checkpoint)
    logits = torch.from_numpy(plain(coords, (vals / np.float32(MAX_RANGE)).astype(np.float32)))
    rows = torch.log_softmax(logits, -1)[torch.from_numpy(coords[:, -1]).long()]
    np.testing.assert_allclose(got, rows.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("unit", ["row", "event", "auto"])
def test_output_unit_unpads_like_jax(checkpoint, unit, caplog):
    """On a chunk whose row and event buckets are both 256: per-row
    outputs cut to the 200 rows ("row"), per-event ones to the 150 events
    ("event"), and "auto" takes events with one warning."""
    coords, vals = _square_chunk(np.random.default_rng(2))
    kwargs = {"preprocess": port_pre, "output_unit": unit}
    if unit == "row":
        kwargs["postprocess"] = port_post
    model, jmodel = _models(checkpoint, **kwargs)
    with caplog.at_level(logging.WARNING):
        got = model(coords, vals)
        model(coords, vals)
    want = np.asarray(jmodel(coords, vals))
    assert got.shape == want.shape == ((200, 2) if unit == "row" else (150, 2))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    warned = [r for r in caplog.records if r.name.startswith("waveformml_tpu_torch")
              and "row bucket == event bucket" in r.getMessage()]
    assert len(warned) == (1 if unit == "auto" else 0)


def test_packed_copy_equals_a_copy_per_leaf():
    """Every leaf of a prepared batch (int32 coords and plans, int16
    features, bool masks, int64 labels) comes out of the one packed buffer
    equal to itself, 16-byte aligned."""
    coords, vals = _adc_chunk(np.random.default_rng(3), 30)
    task = LitPSD(Config(copy.deepcopy(CFG)), device="cpu")
    block = FileBlock(coords, vals, np.arange(30) % 2)
    db = task.prepare_block(block, task.row_bucket(block), task.event_bucket(block))
    assert {v.dtype for v in db.values()} == {np.dtype(t) for t in
                                             ("int32", "int16", "bool", "int64")}
    buf, spec = pack_db(db)
    assert [s[0] for s in spec] == sorted(db) and all(s[3] % 16 == 0 for s in spec)
    out = unpack_db(buf, spec)
    for k, v in db.items():
        want = torch.from_numpy(np.ascontiguousarray(v))
        assert out[k].dtype == want.dtype and out[k].shape == want.shape, k
        assert torch.equal(out[k], want), k
    on_cpu = task.to_device(db)
    assert all(torch.equal(on_cpu[k], out[k]) for k in db)


def test_double_buffered_dispatch_equals_synchronous_calls(checkpoint):
    rng = np.random.default_rng(4)
    chunks = [_adc_chunk(rng, n) for n in (17, 40, 9, 33)]
    model, _ = _models(checkpoint, preprocess=port_pre)
    sync = [model(c, v) for c, v in chunks]
    handles = [model.dispatch(*chunks[0])]
    streamed = []
    for c, v in chunks[1:]:
        handles.append(model.dispatch(c, v))          # before the previous fetch
        streamed.append(model.fetch(handles[-2]))
    streamed.append(model.fetch(handles[-1]))
    for got, want in zip(streamed, sync):
        np.testing.assert_array_equal(got, want)


def test_output_unit_is_checked():
    with pytest.raises(ValueError, match="output_unit"):
        InferenceModel(Config(copy.deepcopy(CFG)), {}, device="cpu", output_unit="rows")


# -- on the card ------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_graph_path_matches_the_eager_forward_on_the_card(cuda):
    """Each new layout is captured once; every chunk replays it, the
    launches of the replays are counted, and the outputs (double-buffered)
    equal the eager forward's on the card and the CPU's within the logit
    tolerance."""
    gen = torch.Generator().manual_seed(0)
    task = LitPSD(Config(copy.deepcopy(CFG)), device="cpu")
    for p in task.model.parameters():
        torch.nn.init.normal_(p, 0.0, 0.3, generator=gen)
    state = task.model.state_dict()
    model = InferenceModel(Config(copy.deepcopy(CFG)), state, preprocess=port_pre)
    eager = InferenceModel(Config(copy.deepcopy(CFG)), state, device="cpu",
                           preprocess=port_pre)
    rng = np.random.default_rng(5)
    chunks = [_adc_chunk(rng, n) for n in (40, 40, 300, 41)]
    handles = [model.dispatch(c, v) for c, v in chunks]
    outs = [model.fetch(h) for h in handles]
    assert 1 <= len(model.graphs) <= 3
    assert sum(g.replays for g in model.graphs.values()) == 4
    launches = model.replay_launches()
    assert launches["subm_conv_rows"] == 5 * 4 and launches["site_grouped_matmul"] == 2 * 4
    for (c, v), got in zip(chunks, outs):
        np.testing.assert_allclose(got, eager(c, v), rtol=RTOL, atol=ATOL)
        block = FileBlock(c, v, np.zeros(int(c[:, -1].max()) + 1, np.int64))
        db = model.task.prepare_block(block, model.task.row_bucket(block),
                                      model.task.event_bucket(block))
        direct = model._forward(model.task.to_device(db))[:got.shape[0]].cpu().numpy()
        np.testing.assert_allclose(got, direct, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_packed_copy_to_the_card_equals_a_copy_per_leaf(cuda):
    coords, vals = _adc_chunk(np.random.default_rng(6), 30)
    task = LitPSD(Config(copy.deepcopy(CFG)), device="cuda")
    block = FileBlock(coords, vals, np.arange(30) % 2)
    db = task.prepare_block(block, task.row_bucket(block), task.event_bucket(block))
    out = task.to_device(db)
    for k, v in db.items():
        want = torch.from_numpy(np.ascontiguousarray(v)).cuda()
        assert out[k].is_cuda and out[k].dtype == want.dtype, k
        assert torch.equal(out[k], want), k
