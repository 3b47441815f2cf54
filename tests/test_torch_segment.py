"""The port's per-segment tasks against the JAX package's: ``segment_loss``,
and ``prepare_block``, ``loss_and_metrics`` and ``test_outputs`` of
``LitZ``, ``LitEZ``, ``LitSegClassifier`` and ``LitSegQuantifier``, on the
same seeded blocks (rows on the grid's edges, two rows of one event at one
site, padding rows and an event bucket larger than the events) and the same
model outputs, with the single-ended mask on and off, the phys label width
(z read at column 4), ``UseFFT`` features, and a target column."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waveformml_tpu.config import Config as JaxConfig
from waveformml_tpu.datasets.hdf5_dataset import FileBlock as JaxFileBlock
from waveformml_tpu.engineering import tasks as jtasks
from waveformml_tpu_torch.config import Config
from waveformml_tpu_torch.datasets.hdf5_dataset import FileBlock
from waveformml_tpu_torch.engineering import tasks
from waveformml_tpu_torch.engineering.se_mask import se_loss_mask, seg_status_maps

NX, NY = 14, 11
RTOL, ATOL = 1e-5, 1e-5
N_SAMPLES = 6

Z_NET = {"criterion_class": "L1Loss", "criterion_params": [], "imports": [],
         "net_class": "SingleEndedZConv", "net_type": "2DConvolution", "algorithm": "conv",
         "hparams": {"conv": {"kernel_size": 3, "n_layers": 2}}}
EZ_NET = {"criterion_class": "L1Loss", "criterion_params": [], "imports": [],
          "net_class": "SingleEndedEZConv", "net_type": "2DConvolution",
          "hparams": {"n_conv": 1, "n_point": 1, "conv_position": 1, "version": 0}}
SEG_NET = {"criterion_class": "MSELoss", "criterion_params": [], "imports": [],
           "net_class": "SPConvPreserveNet", "net_type": "2DConvolution",
           "hparams": {"n_conv": 3, "conv_params": {
               "pointwise_factor": 0, "pad_factor": 1.0, "size_factor": 3,
               "stride_factor": 1.2, "n_expansion": 1, "expansion_factor": 1.2,
               "version": 1, "n_contraction": 2}}}


def _config(run_class, net, n_type=1, **net_extra):
    net = copy.deepcopy(net)
    net.update(net_extra)
    return {"run_config": {"exp_name": "t", "run_class": run_class, "imports": []},
            "system_config": {"model_name": "t", "n_samples": N_SAMPLES, "n_type": n_type,
                              "type_names": ["a"] * n_type, "half_precision": 0},
            "net_config": net,
            "optimize_config": {"total_epoch": 1, "lr": 0.01, "imports": [],
                                "optimizer_class": "optim.SGD", "optimizer_params": {}},
            "dataset_config": {"mode": "path", "imports": [], "paths": ["a"],
                               "dataset_class": "PulseDatasetWFPairEZ",
                               "dataset_params": {}}}


def _pair(name, d):
    return (getattr(jtasks, name)(JaxConfig(copy.deepcopy(d))),
            getattr(tasks, name)(Config(copy.deepcopy(d)), device="cpu"))


def _block(seed, labels_width, int_labels=0):
    """Rows at the grid's corners and edges, two rows at one site (event 1),
    single-ended segments among random sites, per-row labels ``[N]`` or
    ``[N, labels_width]``, and a per-row extra."""
    rng = np.random.default_rng(seed)
    se = np.argwhere(seg_status_maps()[0] == 0.5)[:6]
    coords = [[0, 0, 0], [NX - 1, NY - 1, 0], [NX - 1, 0, 0], [3, 4, 1], [3, 4, 1]]
    coords += [[int(x), int(y), 2] for x, y in se]
    coords += [[int(s % NX), int(s // NX), e] for e in range(3, 12)
               for s in rng.choice(NX * NY, size=3, replace=False)]
    coords = np.asarray(coords, np.int32)
    n = coords.shape[0]
    feats = rng.normal(size=(n, 2 * N_SAMPLES)).astype(np.float32)
    shape = (n,) if labels_width is None else (n, labels_width)
    labels = (rng.integers(0, int_labels, shape) if int_labels
              else rng.normal(size=shape)).astype(np.float32)
    return coords, feats, labels, {"E": rng.normal(size=n).astype(np.float32)}


def _prepared(jtask, ptask, block):
    """Both tasks' prepared batches of one block; they are equal."""
    coords, feats, labels, extras = block
    jb = JaxFileBlock(coords, feats, labels, dict(extras))
    pb = FileBlock(coords, feats, labels, dict(extras))
    rb, eb = jtask.row_bucket(jb), jtask.event_bucket(jb)
    assert (ptask.row_bucket(pb), ptask.event_bucket(pb)) == (rb, eb)
    # the JAX task learns the plans its model reads by tracing its init
    jtask.init_variables(jax.random.PRNGKey(0), jtask.prepare_block(jb, rb, eb))
    want = jtask.prepare_block(jb, rb, eb)
    got = ptask.prepare_block(pb, rb, eb)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert "labels_rows" in got and "extra_E" in got
    return ({k: jnp.asarray(v) for k, v in want.items()}, ptask.to_device(got))


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got.detach()) if torch.is_tensor(got) else got,
                               np.asarray(want), rtol=rtol, atol=atol)


def _same_metrics(pres, jres):
    (pl, pw, pm), (jl, jw, jm) = pres, jres
    _close(pl, jl)
    _close(pw, jw)
    assert sorted(pm) == sorted(jm)
    for k in jm:
        _close(pm[k], jm[k])


@pytest.mark.parametrize("se_only", [False, True])
@pytest.mark.parametrize("labels_width", [None, 6])
def test_litz_segment_loss_matches_jax(se_only, labels_width):
    """[N] z labels, or phys-width [N, 6] labels read at column 4; two rows
    at one site scatter their sum; the weight counts occupied sites (the
    single-ended ones under SELoss)."""
    jtask, ptask = _pair("LitZ", _config("LitZ", Z_NET, SELoss=se_only))
    jdb, pdb = _prepared(jtask, ptask, _block(1, labels_width))
    b = pdb["labels"].shape[0]
    out = np.random.default_rng(2).normal(size=(b, 1, NX, NY)).astype(np.float32)
    _same_metrics(ptask.loss_and_metrics(torch.from_numpy(out), pdb),
                  jtask.loss_and_metrics(jnp.asarray(out), jdb))
    got = ptask.segment_loss(torch.from_numpy(out), pdb, pdb["labels_rows"])
    want = jtask.segment_loss(jnp.asarray(out), jdb, jdb["labels_rows"])
    for g, w in zip(got, want):
        _close(g, w)
    got_t = ptask.test_outputs(torch.from_numpy(out), pdb)
    want_t = jtask.test_outputs(jnp.asarray(out), jdb)
    assert sorted(got_t) == sorted(want_t) == ["predictions", "target"]
    for k in want_t:
        _close(got_t[k], want_t[k])
    if se_only:
        np.testing.assert_array_equal(ptask.se_mask.numpy(), se_loss_mask())
        assert 0 < float(got[1]) < float(ptask.segment_loss(
            torch.from_numpy(out), pdb, pdb["labels_rows"])[2].numel())


def test_litz_use_fft_features_match_jax():
    jtask, ptask = _pair("LitZ", _config("LitZ", Z_NET, UseFFT=True))
    jdb, pdb = _prepared(jtask, ptask, _block(3, None))
    got = ptask._features(pdb)
    want = jtask._features(jdb)
    assert got.shape == (pdb["feats"].shape[0], 2 * N_SAMPLES + 2)
    _close(got, want, atol=1e-4)


@pytest.mark.parametrize("se_only", [False, True])
def test_litez_losses_and_outputs_match_jax(se_only):
    jtask, ptask = _pair("LitEZ", _config("LitEZ", EZ_NET, SELoss=se_only))
    jdb, pdb = _prepared(jtask, ptask, _block(4, 2))
    b = pdb["labels"].shape[0]
    out = np.random.default_rng(5).normal(size=(b, 2, NX, NY)).astype(np.float32)
    _same_metrics(ptask.loss_and_metrics(torch.from_numpy(out), pdb),
                  jtask.loss_and_metrics(jnp.asarray(out), jdb))
    got_t = ptask.test_outputs(torch.from_numpy(out), pdb)
    want_t = jtask.test_outputs(jnp.asarray(out), jdb)
    for k in ("predictions", "target"):
        assert got_t[k].shape == (b, 2, NX, NY)
        _close(got_t[k], want_t[k])


def test_litez_rescales_phys_features_like_jax():
    jtask, ptask = _pair("LitEZ", _config("LitEZ", EZ_NET, algorithm="features",
                                          escale=6.0, e_adjust=12.0))
    jdb, pdb = _prepared(jtask, ptask, _block(6, 2))
    got = ptask._features(pdb)
    _close(got, jtask._features(jdb))
    np.testing.assert_allclose(got[:, 0].numpy(), 0.5 * pdb["feats"][:, 0].numpy())
    assert torch.equal(got[:, 1], pdb["feats"][:, 1])


@pytest.mark.parametrize("se_only", [False, True])
@pytest.mark.parametrize("target_index", [None, 1])
def test_litsegquantifier_matches_jax(se_only, target_index):
    extra = {"SELoss": se_only}
    if target_index is not None:
        extra["target_index"] = target_index
    jtask, ptask = _pair("LitSegQuantifier",
                         _config("LitSegQuantifier", SEG_NET, **extra))
    jdb, pdb = _prepared(jtask, ptask, _block(7, 2))
    n = pdb["mask"].shape[0]
    out = np.random.default_rng(8).normal(size=(n, 1)).astype(np.float32)
    pres = ptask.loss_and_metrics(torch.from_numpy(out), pdb)
    _same_metrics(pres, jtask.loss_and_metrics(jnp.asarray(out), jdb))
    n_real = int(pdb["mask"].sum())
    assert (float(pres[1]) < n_real) if se_only else (float(pres[1]) == n_real)
    _close(ptask.test_outputs(torch.from_numpy(out), pdb)["predictions"],
           jtask.test_outputs(jnp.asarray(out), jdb)["predictions"])


@pytest.mark.parametrize("se_only", [False, True])
def test_litsegclassifier_matches_jax(se_only):
    net = copy.deepcopy(SEG_NET)
    net["criterion_class"] = "CrossEntropyLoss"
    jtask, ptask = _pair("LitSegClassifier",
                         _config("LitSegClassifier", net, n_type=3, SELoss=se_only))
    jdb, pdb = _prepared(jtask, ptask, _block(9, None, int_labels=3))
    n = pdb["mask"].shape[0]
    out = np.random.default_rng(10).normal(size=(n, 3)).astype(np.float32)
    _same_metrics(ptask.loss_and_metrics(torch.from_numpy(out), pdb),
                  jtask.loss_and_metrics(jnp.asarray(out), jdb))
    got_t = ptask.test_outputs(torch.from_numpy(out), pdb)
    want_t = jtask.test_outputs(jnp.asarray(out), jdb)
    assert sorted(got_t) == sorted(want_t)
    for k in want_t:
        _close(got_t[k], want_t[k])


@pytest.mark.parametrize("name,kwargs", [("L1Loss", {}), ("MSELoss", {}),
                                         ("SmoothL1Loss", {"beta": 0.5}),
                                         ("HuberLoss", {"delta": 0.7}),
                                         ("BCEWithLogitsLoss", {}), ("BCELoss", {})])
def test_criteria_match_jax(name, kwargs):
    from waveformml_tpu.nn import functional as jf
    from waveformml_tpu_torch.nn import functional as pf

    rng = np.random.default_rng(11)
    pred = rng.normal(size=(40, 3)).astype(np.float32)
    target = rng.normal(size=(40, 3)).astype(np.float32)
    if name.startswith("BCE"):
        target = (target > 0).astype(np.float32)
        if name == "BCELoss":
            pred = 1 / (1 + np.exp(-pred))
    got = getattr(pf, name)(**kwargs)
    want = getattr(jf, name)(reduction="none", **kwargs)
    _close(got.elementwise(torch.from_numpy(pred), torch.from_numpy(target)),
           want.elementwise(jnp.asarray(pred), jnp.asarray(target)))
    assert got.mean_denominator(torch.from_numpy(target)) is None


def test_criterion_params_are_refused():
    from waveformml_tpu_torch.nn.functional import build_criterion

    with pytest.raises(ValueError, match="unsupported criterion params"):
        build_criterion("MSELoss", [1.0])


def test_evaluators_are_not_ported_yet():
    """Each segment task's ``make_evaluator`` builds the JAX task's
    evaluator class with its settings; the base, which every task
    overrides (``LitWaveform``'s since it was ported), raises."""
    from waveformml_tpu_torch.engineering.base import TaskBase

    classifier = copy.deepcopy(SEG_NET)
    classifier["criterion_class"] = "CrossEntropyLoss"
    for name, cfg in (("LitZ", _config("LitZ", Z_NET)),
                      ("LitZ", _config("LitZ", Z_NET, algorithm="features")),
                      ("LitEZ", _config("LitEZ", EZ_NET)),
                      ("LitEZ", _config("LitEZ", EZ_NET, algorithm="features")),
                      ("LitSegQuantifier", _config("LitSegQuantifier", SEG_NET,
                                                   target_index=1, SELoss=True)),
                      ("LitSegClassifier", _config("LitSegClassifier", classifier, n_type=5))):
        jtask, ptask = _pair(name, cfg)
        want, got = jtask.make_evaluator(), ptask.make_evaluator()
        assert type(got).__name__ == type(want).__name__, name
        assert type(got).__module__ == type(want).__module__.replace(
            "waveformml_tpu.", "waveformml_tpu_torch."), name
        for attr in ("SE_only", "target_index", "E_scale", "hascal"):
            assert getattr(got, attr, None) == getattr(want, attr, None), (name, attr)
    with pytest.raises(NotImplementedError, match="has no evaluator"):
        TaskBase.make_evaluator(ptask)
