"""The per-segment slice end to end against the JAX package, at narrow
widths: SingleEndedZCNN.json (``LitZ`` + ``SingleEndedZConv``, regular
sparse convs on the dense grid) and SegQuantifier.json (``LitSegQuantifier``
+ ``SPConvPreserveNet``, a SubM chain on the row path) as shipped but for
``n_samples``. From the same flax weights (``convert.py``): the forward,
``InferenceModel`` against the JAX ``InferenceModel`` on one orbax
checkpoint, and a 10-step training trajectory against the JAX ``Trainer``
(rtol 2e-3, atol 2e-4); a ``LitEZ`` with a frozen Z checkpoint; the weights'
round trip. Card tests hold K1 and K4 at SegQuantifier's shipped widths
against their plain versions, and the grid conv to float32 with the
process's TF32 flags on."""
import copy
import json
import os

import numpy as np
import pytest
import torch

from waveformml_tpu_torch.config import Config, load_config, to_dict
from waveformml_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from waveformml_tpu_torch.datasets.hdf5_dataset import FileBlock
from waveformml_tpu_torch.datasets.synthetic import BlockDataModule, segment_block
from waveformml_tpu_torch.engineering.tasks import LitEZ, LitSegQuantifier, LitZ
from waveformml_tpu_torch.engineering.trainer import Trainer
from waveformml_tpu_torch.inference.model import InferenceModel
from waveformml_tpu_torch.models.sparse_blocks import RowSubMConv2d

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NX, NY = 14, 11
N_SAMPLES = 8
RTOL, ATOL = 1e-4, 1e-5              # tests/test_torch_slice.py's output tolerance
TRAIN_RTOL, TRAIN_ATOL = 2e-3, 2e-4
EPOCHS, STEPS = 2, 5


def _config(name, **net):
    """A shipped example config at N_SAMPLES samples a waveform."""
    d = to_dict(load_config(os.path.join(ROOT, "config", "examples", f"{name}.json")))
    d["system_config"]["n_samples"] = N_SAMPLES
    d["net_config"].update(net)
    return d


SLICES = {"z": ("SingleEndedZCNN", LitZ, "z"), "segq": ("SegQuantifier", LitSegQuantifier, "ez")}


def _blocks(rng, n, label, n_events=12):
    return [segment_block(rng, n_events, N_SAMPLES, label=label) for _ in range(n)]


def _jax_trainer(d, block, seed=0):
    """A JAX Trainer on one device with its state built from ``block``."""
    import jax

    from waveformml_tpu.config import Config as JaxConfig
    from waveformml_tpu.datasets.hdf5_dataset import FileBlock as JaxFileBlock
    from waveformml_tpu.engineering import tasks as jtasks
    from waveformml_tpu.engineering.trainer import Trainer as JaxTrainer
    from waveformml_tpu.parallel.mesh import make_mesh

    jcfg = JaxConfig(copy.deepcopy(d))
    task = getattr(jtasks, d["run_config"]["run_class"])(jcfg)
    jt = JaxTrainer(jcfg, task, mesh=make_mesh(jax.devices()[:1]), seed=seed, callbacks=[])
    jt._ensure_state(JaxFileBlock(block.coords, block.feats, block.labels, {}))
    return jt


def _jax_db(jt, block):
    """The JAX task's prepared batch of a block, on the device, unstacked."""
    import jax.numpy as jnp

    from waveformml_tpu.datasets.hdf5_dataset import FileBlock as JaxFileBlock

    jb = JaxFileBlock(block.coords, block.feats, block.labels, {})
    db = jt.task.prepare_block(jb, jt.task.row_bucket(jb), jt.task.event_bucket(jb))
    return {k: jnp.asarray(v) for k, v in db.items()}


def _flat(jt):
    import jax
    from flax.traverse_util import flatten_dict

    return {k: np.asarray(v) for k, v in flatten_dict(
        jax.device_get({"params": jt.state.params, "batch_stats": jt.state.batch_stats}),
        sep="/").items()}


def _redraw(jt, seed):
    """Biases, BatchNorm scales and statistics redrawn (init leaves them
    trivial); returns the flat variables."""
    import jax.numpy as jnp
    from flax.traverse_util import unflatten_dict

    rng = np.random.default_rng(seed)
    flat = {}
    for k, v in _flat(jt).items():
        if k.endswith("/kernel"):
            value = v
        elif k.endswith("/var"):
            value = rng.uniform(0.5, 2.0, size=v.shape)
        else:
            value = rng.normal(size=v.shape) * 0.1 + k.endswith("/scale")
        flat[k] = value.astype(np.float32)
    tree = unflatten_dict({tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})
    jt.state.params, jt.state.batch_stats = tree["params"], tree["batch_stats"]
    return flat


@pytest.fixture(scope="module", params=sorted(SLICES))
def served(request, tmp_path_factory):
    """One slice's JAX Trainer with redrawn weights saved as an orbax
    checkpoint, the same weights as a port state_dict, and a chunk whose
    row and event buckets are equal (both 256)."""
    name, _, label = SLICES[request.param]
    d = _config(name)
    rng = np.random.default_rng(31)
    chunk = segment_block(rng, 150, N_SAMPLES, label=label, max_mult=1)
    jt = _jax_trainer(d, chunk)
    flat = _redraw(jt, 32)
    path = str(tmp_path_factory.mktemp(request.param) / "epoch=0-val_loss=0.50.ckpt")
    jt.save_checkpoint(path)
    return dict(key=request.param, d=d, jt=jt, flat=flat, path=path, chunk=chunk)


def test_forward_matches_jax(served):
    jt, chunk = served["jt"], served["chunk"]
    _, cls, _ = SLICES[served["key"]]
    task = cls(Config(copy.deepcopy(served["d"])), device="cpu")
    task.model.load_state_dict(flax_to_state_dict(served["flat"]))
    block = FileBlock(chunk.coords, chunk.feats, chunk.labels)
    db = task.prepare_block(block, task.row_bucket(block), task.event_bucket(block))
    jdb = _jax_db(jt, block)
    assert sorted(db) == sorted(jdb)
    want = np.asarray(jt.task.apply_model({"params": jt.state.params,
                                           "batch_stats": jt.state.batch_stats},
                                          jdb, train=False)[0])
    got = task.apply_model(task.to_device(db)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert task.model.stack.row_path == (served["key"] == "segq")


def test_inference_model_matches_jax(served):
    """Row and event buckets are equal here: the port un-pads by its task's
    unit (the Z map per event, SegQuantifier's outputs per row)."""
    from waveformml_tpu.inference.model import InferenceModel as JaxInferenceModel

    unit = "event" if served["key"] == "z" else "row"
    port = InferenceModel(Config(copy.deepcopy(served["d"])),
                          flax_to_state_dict(served["flat"]), device="cpu")
    jax_model = JaxInferenceModel(served["jt"].config, served["path"], output_unit=unit)
    chunk = served["chunk"]
    got = port(chunk.coords, chunk.feats)
    want = np.asarray(jax_model(chunk.coords, chunk.feats))
    n = chunk.coords.shape[0]
    assert got.shape == ((150, 1, NX, NY) if unit == "event" else (n, 1))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module", params=sorted(SLICES))
def trajectories(request, tmp_path_factory):
    """The JAX Trainer stepped through its train step and ExponentialLR as
    its fit does, and the port's Trainer.fit from the converted init, over
    EPOCHS × STEPS blocks of per-row labels."""
    import jax
    import jax.numpy as jnp

    from waveformml_tpu import optim as wopt
    from waveformml_tpu.datasets.hdf5_dataset import FileBlock as JaxFileBlock

    name, cls, label = SLICES[request.param]
    d = _config(name)
    d["optimize_config"]["lr"] = 0.02
    rng = np.random.default_rng(41)
    train, val = _blocks(rng, STEPS, label), _blocks(rng, 1, label)
    jt = _jax_trainer(d, train[0])
    init = flax_to_state_dict(_flat(jt))
    jax_losses = []
    for epoch in range(EPOCHS):
        for i, b in enumerate(train):
            db = {k: jnp.asarray(v) for k, v in jt._device_batch(
                JaxFileBlock(b.coords, b.feats, b.labels, {})).items()}
            st = jt.state
            st.params, st.batch_stats, st.opt_state, loss, _ = jt._train_step_fn(
                st.params, st.batch_stats, st.opt_state,
                jax.random.PRNGKey(epoch * STEPS + i), db)
            jax_losses.append(float(loss))
        jt.state.opt_state = wopt.set_learning_rate(jt.state.opt_state, jt.scheduler.step())
    cfg = Config(copy.deepcopy(d))
    task = cls(cfg, device="cpu")
    task.model.load_state_dict(init)
    trainer = Trainer(cfg, task, device="cpu", max_epochs=EPOCHS,
                      checkpoint_dir=str(tmp_path_factory.mktemp("ckpt")))
    metrics = trainer.fit(BlockDataModule(train, val, val))
    return dict(key=request.param, trainer=trainer, metrics=metrics, jax_losses=jax_losses,
                jax_stats=_flat(jt), val=val, d=d)


def test_training_losses_match_jax(trajectories):
    got = np.asarray(trajectories["trainer"].step_losses)
    want = np.asarray(trajectories["jax_losses"])
    assert got.shape == want.shape == (EPOCHS * STEPS,)
    np.testing.assert_allclose(got, want, rtol=TRAIN_RTOL, atol=TRAIN_ATOL)
    stats = {k: v for k, v in flax_to_state_dict(trajectories["jax_stats"]).items()
             if "running" in k}
    state = trajectories["trainer"].task.model.state_dict()
    assert stats
    for k, v in stats.items():
        np.testing.assert_allclose(state[k].numpy(), v.numpy(), rtol=1e-3, atol=1e-4,
                                   err_msg=k)


def test_training_metrics_and_checkpoint(trajectories):
    """The metrics the JAX Trainer reports for the task, and the best
    checkpoint serving the validation block with its recorded loss."""
    trainer, metrics = trajectories["trainer"], trajectories["metrics"]
    keys = {"train_loss", "val_loss"}
    if trajectories["key"] == "segq":
        keys |= {"train_mse", "val_mse"}
        # SegQuantifier's MSE criterion: the loss is the mse metric
        assert metrics["val_mse"] == pytest.approx(metrics["val_loss"], rel=1e-5)
    assert set(metrics) == keys
    assert len(trainer.step_phases) == EPOCHS * STEPS
    assert trainer.step_phases[0]["events"] == 12
    served = InferenceModel(Config(copy.deepcopy(trajectories["d"])), trainer.best_ckpt_path,
                            device="cpu")
    val = trajectories["val"][0]
    out = served(val.coords, val.feats)
    test = trainer.test(BlockDataModule([], [], [val]))
    assert np.isfinite(out).all()
    assert test["test_loss"] == pytest.approx(trainer.best_val_loss, rel=1e-5)


def test_per_row_test_outputs_are_collected_per_row(trajectories):
    trainer = trajectories["trainer"]
    val = trajectories["val"][0]
    seen = []
    trainer.test(BlockDataModule([], [], [val]),
                 collect=lambda block, db, out: seen.append(out))
    out = seen[0]
    if trajectories["key"] == "segq":
        assert out["predictions"].shape == (val.coords.shape[0], 1)
    else:
        assert out["predictions"].shape == out["target"].shape == (12, 1, NX, NY)


@pytest.mark.parametrize("variant", [
    {"algorithm": "point", "hparams": {"point": {"pointwise_layers": 2}}},
    {"UseFFT": True},
    {"version": 1, "hparams": {"kernel_size": 3, "n_conv": 1, "n_point": 1,
                               "conv_position": 1, "version": 2}},
])
def test_z_variants_match_jax(variant):
    """SingleEndedZConv's other paths: the pointwise stack, the grid stack
    over the rFFT features (its first conv takes their width, as flax
    infers it), and version 1 with a SubM schedule (the stack's own version
    2), on the row path (K1)."""
    import jax.numpy as jnp

    d = _config("SingleEndedZCNN", **variant)
    rng = np.random.default_rng(51)
    block = segment_block(rng, 20, N_SAMPLES, label="z")
    jt = _jax_trainer(d, block)
    flat = _redraw(jt, 52)
    task = LitZ(Config(copy.deepcopy(d)), device="cpu")
    task.model.load_state_dict(flax_to_state_dict(flat))
    assert task.model.stack.row_path == (variant.get("version", 0) >= 1)
    db = task.prepare_block(block, task.row_bucket(block), task.event_bucket(block))
    jdb = _jax_db(jt, block)
    assert sorted(db) == sorted(jdb)
    want = np.asarray(jt.task.apply_model({"params": jt.state.params,
                                           "batch_stats": jt.state.batch_stats},
                                          jdb, train=False)[0])
    np.testing.assert_allclose(task.apply_model(task.to_device(db)).numpy(), want,
                               rtol=RTOL, atol=ATOL)


def test_weights_round_trip_through_convert(served):
    _, cls, _ = SLICES[served["key"]]
    task = cls(Config(copy.deepcopy(served["d"])), device="cpu")
    state = flax_to_state_dict(served["flat"])
    assert sorted(state) == sorted(task.model.state_dict())
    for k, v in task.model.state_dict().items():
        assert state[k].shape == v.shape, k
    back = state_dict_to_flax(state)
    assert sorted(back) == sorted(served["flat"])
    for k, v in served["flat"].items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_litez_with_a_frozen_z_model(tmp_path):
    """A LitEZ whose net_config names a port Z checkpoint: its second plane
    is the frozen Z model's output; the Z parameters are neither the
    model's nor the optimizer's, get no gradient and do not move while the
    E stack trains."""
    z_cfg = _config("SingleEndedZCNN")
    z_task = LitZ(Config(copy.deepcopy(z_cfg)), device="cpu")
    gen = torch.Generator().manual_seed(3)
    for p in z_task.model.parameters():
        torch.nn.init.normal_(p, 0.0, 0.3, generator=gen)
    z_path, cfg_path = tmp_path / "z.pt", tmp_path / "z.json"
    torch.save(z_task.model.state_dict(), z_path)
    cfg_path.write_text(json.dumps(z_cfg))
    d = copy.deepcopy(z_cfg)
    d["run_config"]["run_class"] = "LitEZ"
    d["net_config"].update(net_class="SingleEndedEZConv", z_weights=str(z_path),
                           z_config=str(cfg_path),
                           hparams={"n_conv": 1, "n_point": 1, "conv_position": 1})
    cfg = Config(d)
    task = LitEZ(cfg, device="cpu")
    with torch.no_grad():
        # keep the E plane's final ReLU alive on this small batch
        task.model.stack.l3.conv.bias.fill_(1.0)
    z_model = task.model._z_model[0]
    z_before = {k: v.clone() for k, v in z_model.state_dict().items()}
    assert not any(k.startswith("_z") for k in task.model.state_dict())
    ids = {id(p) for p in z_model.parameters()}
    assert not ids & {id(p) for p in task.model.parameters()}
    rng = np.random.default_rng(61)
    blocks = _blocks(rng, 3, "ez")
    block = blocks[0]
    db = task.to_device(task.prepare_block(block, task.row_bucket(block),
                                           task.event_bucket(block)))
    out = task.apply_model(db)
    assert out.shape[1:] == (2, NX, NY)
    z_direct = z_task.apply_model(db)
    np.testing.assert_allclose(out[:, 1:2].numpy(), z_direct.numpy(), rtol=1e-6, atol=1e-7)
    trainer = Trainer(cfg, task, device="cpu", max_epochs=1)
    assert not ids & {id(p) for g in trainer.optimizer.param_groups for p in g["params"]}
    metrics = trainer.fit(BlockDataModule(blocks, blocks[:1]))
    assert set(metrics) >= {"train_MAE_z", "train_MAE_E", "val_MAE_z", "val_MAE_E"}
    assert all(p.grad is None for p in z_model.parameters())
    assert any(p.grad is not None and p.grad.abs().sum() > 0 for p in task.model.parameters())
    for k, v in z_model.state_dict().items():
        assert torch.equal(v, z_before[k]), k


# -- on the card ------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _segq_card_batch():
    """SegQuantifier.json as shipped, seeded random weights, on the card,
    and one prepared batch of 2048 events."""
    task = LitSegQuantifier(load_config(os.path.join(ROOT, "config", "examples",
                                                     "SegQuantifier.json")))
    block = segment_block(np.random.default_rng(71), 2048, 65, label="ez")
    db = task.to_device(task.prepare_block(block, task.row_bucket(block),
                                           task.event_bucket(block)))
    return task, db


@pytest.mark.cuda
def test_k1_at_segquantifier_widths_on_the_card(cuda):
    """K1 at 130→156, 156→78 and 78→1 (one output column; rows of 312 bytes
    at Cin = 78) against its plain version."""
    from waveformml_tpu_torch.ops.row_conv import subm_conv_rows, subm_conv_rows_plain

    task, db = _segq_card_batch()
    convs = [m for m in task.model.modules() if isinstance(m, RowSubMConv2d)]
    assert [tuple(m.weight.shape[1:]) for m in convs] == [(130, 156), (156, 78), (78, 1)]
    gen = torch.Generator(device="cuda").manual_seed(0)
    mask = db["mask"]
    for conv in convs:
        cin = conv.weight.shape[1]
        feats = torch.randn(mask.shape[0], cin, device="cuda", generator=gen)
        feats = torch.where(mask[:, None], feats, 0.0).contiguous()
        args = (feats, db["plan_k3"], conv.weight.detach(), conv.bias.detach(), mask)
        got, want = subm_conv_rows(*args), subm_conv_rows_plain(*args)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_k4_at_segquantifier_widths_on_the_card(cuda):
    """K4 at the three convs (Cin + 1 = 157: two Cin tiles; Cout = 1)
    against its plain version, each output within 1e-5 of the sum of its
    terms' magnitudes, and bitwise equal over two runs."""
    from waveformml_tpu_torch.ops.row_conv import (subm_conv_rows_wgrad,
                                                   subm_conv_rows_wgrad_plain)

    task, db = _segq_card_batch()
    convs = [m for m in task.model.modules() if isinstance(m, RowSubMConv2d)]
    gen = torch.Generator(device="cuda").manual_seed(1)
    mask, plan = db["mask"], db["plan_k3"]
    for conv in convs:
        _, cin, cout = conv.weight.shape
        feats = torch.relu(torch.randn(mask.shape[0], cin, device="cuda", generator=gen))
        feats = torch.where(mask[:, None], feats, 0.0).contiguous()
        g = torch.randn(mask.shape[0], cout, device="cuda", generator=gen)
        g = torch.where(mask[:, None], g, 0.0).contiguous()
        got = subm_conv_rows_wgrad(feats, plan, g, mask)
        again = subm_conv_rows_wgrad(feats, plan, g, mask)
        want = subm_conv_rows_wgrad_plain(feats, plan, g, mask)
        scale = subm_conv_rows_wgrad_plain(feats.abs(), plan, g.abs(), mask)
        for a, b, s, c in zip(got, want, scale, again):
            assert bool(((a - b).abs() <= 1e-5 * s + 1e-30).all())
            assert torch.equal(a, c)


def _conv_precision():
    conv = getattr(torch.backends.cudnn, "conv", None)
    if conv is not None and hasattr(conv, "fp32_precision"):
        return conv.fp32_precision
    return "tf32" if torch.backends.cudnn.allow_tf32 else "ieee"


def _set_tf32(on: bool):
    conv = getattr(torch.backends.cudnn, "conv", None)
    if conv is not None and hasattr(conv, "fp32_precision"):
        conv.fp32_precision = "tf32" if on else "ieee"
    else:
        torch.backends.cudnn.allow_tf32 = on


@pytest.mark.cuda
def test_dense_convs_are_fp32_on_the_card_with_tf32_on(cuda):
    """SingleEndedZCNN's first conv (300→150, 3×3) on the card with the
    process's TF32 flags on: forward and weight gradient within float32
    rounding of a float64 run, far inside TF32's error."""
    rng = np.random.default_rng(14)
    from waveformml_tpu_torch.ops import sparse_conv as sc

    x = torch.from_numpy(rng.normal(size=(64, 300, NX, NY)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(150, 300, 3, 3)).astype(np.float32) / 52)
    before = _conv_precision()
    _set_tf32(True)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        xc, wc = x.cuda(), w.cuda().requires_grad_()
        y = sc.conv(xc, wc, None, (1, 1), (1, 1), (1, 1))
        y.square().sum().backward()
        y64 = torch.nn.functional.conv2d(x.double(), w.double(), padding=1)
        w64 = w.double().requires_grad_()
        torch.nn.functional.conv2d(x.double(), w64, padding=1).square().sum().backward()
        scale = torch.nn.functional.conv2d(x.double().abs(), w.double().abs(), padding=1)
        err = ((y.double().cpu() - y64).abs() / scale.clamp(min=1e-30)).max().item()
        assert err < 1e-5, err
        gerr = ((wc.grad.double().cpu() - w64.grad).abs().max()
                / w64.grad.abs().max()).item()
        assert gerr < 1e-5, gerr
    finally:
        _set_tf32(before == "tf32")
        torch.backends.cuda.matmul.allow_tf32 = False
