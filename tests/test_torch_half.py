"""``half_precision: 1`` of the port against the JAX package, on the CPU
(plain kernel versions, JAX in its own CPU path): bf16 features, float32
parameters, the first conv's product rounded to bf16 before its float32
bias, float32 after it.

Tolerances:

* the first conv's output at its bf16 rounding point: at most 0.1% of the
  elements differ. The two float32 sums of 9·130 products differ by ~1e-7
  of the sum of the products' magnitudes, so a rounding flips only where a
  sum lies that close to a bf16 rounding boundary (a bf16 ulp is 2^-8
  relative): such an element is one bf16 ulp apart. Where the sum cancels
  (its value ~1e-6 of the magnitudes), that summation difference exceeds a
  bf16 ulp of the value, and the two may be several ulps apart: such an
  element is held to 1e-6 of the magnitudes (seen here: 53 of 263328
  elements differ, 3 of them by more than one ulp, the worst by 66 ulps
  and 6.1e-8 of the magnitudes);
* logits: atol 2e-3, rtol 1e-2 (weights with calibrated BatchNorm
  statistics and random biases, so that logits are O(1); seen: 3.6e-7
  at logits up to 1.0);
* a 10-step trajectory of the JAX ``Trainer`` on ``PSDDataModule`` batches
  from synthetic HDF5 files: losses within rtol 1e-3 (seen: 1.1e-5).
"""
import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from waveformml_tpu_torch.config import Config, load_config
from waveformml_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from waveformml_tpu_torch.datasets.hdf5_dataset import FileBlock
from waveformml_tpu_torch.datasets.synthetic import make_events
from waveformml_tpu_torch.detector import MAX_RANGE
from waveformml_tpu_torch.engineering.tasks import LitPSD
from waveformml_tpu_torch.ops.row_conv import SubMConvRows, subm_conv_rows_plain

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "config", "examples")
FLIP_SHARE = 1e-3          # elements whose bf16 rounding may differ
CANCEL_TOL = 1e-6          # of Σ|terms|, where a sum cancels
LOGIT_ATOL, LOGIT_RTOL = 2e-3, 1e-2
LOSS_RTOL = 1e-3


def _half_chunk(seed: int, n_events: int):
    """A chunk of synthetic events at 65 samples a PMT: coords and the
    waveforms scaled to [0, 1] as float16, what half_precision's datasets
    return."""
    ev = make_events(np.random.default_rng(seed), n_events, 65)
    return ev["coords"], (ev["waveforms"] / MAX_RANGE).astype(np.float16)


def test_first_conv_rounding_point_matches_jax():
    from waveformml_tpu.ops.row_conv import host_neighbor_plan, subm_conv_rows

    coords, feats = _half_chunk(0, 1024)
    n = coords.shape[0]
    c = np.zeros((n + 7, 3), np.int32)
    c[:n] = coords
    mask = np.arange(n + 7) < n
    f = np.zeros((n + 7, 130), np.float16)
    f[:n] = feats
    plan = host_neighbor_plan(c, mask, 1024, 3)
    rng = np.random.default_rng(1)
    kernel = (rng.normal(size=(9, 130, 104)) / np.sqrt(9 * 130)).astype(np.float32)

    want = np.asarray(subm_conv_rows(jnp.asarray(f).astype(jnp.bfloat16), jnp.asarray(plan),
                                     jnp.asarray(kernel), None, jnp.asarray(mask)))
    args = [torch.from_numpy(a) for a in (plan, kernel)]
    feats_t = torch.from_numpy(f).to(torch.bfloat16)
    got = SubMConvRows.apply(feats_t, args[0], args[1], None, torch.from_numpy(mask))
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    scale = subm_conv_rows_plain(feats_t.float().abs(), args[0], args[1].abs(), None,
                                 torch.from_numpy(mask)).numpy()

    bits_want = want.view(np.int16).astype(np.int32)
    bits_got = got.view(torch.int16).numpy().astype(np.int32)
    differ = bits_want != bits_got
    assert differ.sum() <= FLIP_SHARE * differ.size, (differ.sum(), differ.size)
    one_ulp = (np.abs(bits_want - bits_got) == 1) & (np.sign(want.astype(np.float32))
                                                     == got.float().sign().numpy())
    gap = np.abs(want.astype(np.float32) - got.float().numpy())
    cancels = gap <= CANCEL_TOL * scale
    assert (one_ulp | cancels)[differ].all()


def _calibrated(task: LitPSD, db, seed: int):
    """The task's weights with BatchNorm running statistics of this batch
    (train-mode forwards) and random biases and BatchNorm scales, so that
    the logits are O(1)."""
    model = task.model
    model.train()
    with torch.no_grad():
        for _ in range(30):
            model(task.sparse_batch(db))
    gen = torch.Generator().manual_seed(seed)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    for k, v in state.items():
        if k.endswith(".bias"):
            v.copy_(0.3 * torch.randn(v.shape, generator=gen))
        elif k.endswith(".weight") and k.replace(".weight", ".running_mean") in state:
            v.copy_(0.5 + torch.rand(v.shape, generator=gen))
    model.load_state_dict(state)
    return state


@pytest.mark.parametrize("name,n_events", [("SubMPSD", 256), ("SubMPSD_w128", 64)])
def test_half_logits_match_jax(name, n_events):
    from waveformml_tpu.config import load_config as jax_load_config
    from waveformml_tpu.datasets.hdf5_dataset import FileBlock as JaxFileBlock
    from waveformml_tpu.engineering.tasks import LitPSD as JaxLitPSD

    path = os.path.join(EXAMPLES, f"{name}.json")
    coords, feats = _half_chunk(2, n_events)
    block = FileBlock(coords, feats, np.zeros(n_events, np.int64))

    jcfg = jax_load_config(path)
    jcfg.system_config.half_precision = 1
    jtask = JaxLitPSD(jcfg)
    jblock = JaxFileBlock(coords, feats, block.labels, {})
    jdb = {k: jnp.asarray(v) for k, v in jtask.prepare_block(
        jblock, jtask.row_bucket(jblock), jtask.event_bucket(jblock)).items()}
    init = flatten_dict(jax.device_get(jtask.init_variables(jax.random.PRNGKey(3), jdb)),
                        sep="/")

    cfg = load_config(path)
    cfg.system_config.half_precision = 1
    task = LitPSD(cfg, device="cpu")
    task.model.load_state_dict(flax_to_state_dict({k: np.asarray(v) for k, v in init.items()}))
    db = task.to_device(task.prepare_block(block, task.row_bucket(block),
                                           task.event_bucket(block)))
    assert db["feats"].dtype == torch.float16
    state = _calibrated(task, db, seed=4)
    got = task.apply_model(db).numpy()[:n_events]

    variables = unflatten_dict({k: jnp.asarray(v) for k, v in
                                state_dict_to_flax(state).items()}, sep="/")
    want = np.asarray(jtask.apply_model(variables, jdb, train=False)[0])[:n_events]
    assert got.dtype == want.dtype == np.float32
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=LOGIT_RTOL, atol=LOGIT_ATOL)


def test_half_trajectory_matches_jax_trainer(tmp_path):
    """10 steps (2 epochs of 5 shuffled blocks of combined files) of the
    JAX Trainer and the port's, from the same init, on the same HDF5 files
    through each package's PSDDataModule; the fit metrics carry the same
    keys."""
    from waveformml_tpu.config import Config as JaxConfig
    from waveformml_tpu.config import validate_config as jax_validate
    from waveformml_tpu.datasets.data_module import PSDDataModule as JaxPSDDataModule
    from waveformml_tpu.datasets.synthetic import write_classification_dirs
    from waveformml_tpu.engineering.tasks import LitPSD as JaxLitPSD
    from waveformml_tpu.engineering.trainer import Trainer as JaxTrainer
    from waveformml_tpu.parallel.mesh import make_mesh

    from waveformml_tpu_torch.datasets.data_module import PSDDataModule
    from waveformml_tpu_torch.engineering.trainer import Trainer

    data = tmp_path / "data"
    write_classification_dirs(str(data), ["Ioni", "Recoil"], n_files=3, events_per_file=40,
                              n_samples=65, seed=5)
    with open(os.path.join(EXAMPLES, "SubMPSD.json")) as f:
        base = json.load(f)
    base["system_config"]["half_precision"] = 1
    base["dataset_config"].update(base_path=str(data), n_train=40, n_validate=40,
                                  n_test=40, shuffled_size=16,
                                  dataloader_params={"batch_size": 1, "num_workers": 0})

    def config(cls, root):
        d = copy.deepcopy(base)
        d["system_config"]["model_base_path"] = str(tmp_path / root / "model")
        return cls(d)

    jcfg = jax_validate(config(JaxConfig, "jax"))
    jdm = JaxPSDDataModule(jcfg)
    jdm.setup("fit")
    jt = JaxTrainer(jcfg, JaxLitPSD(jcfg), mesh=make_mesh(jax.devices()[:1]), seed=0,
                    max_epochs=2)
    jt._ensure_state(next(iter(jdm.train_dataloader())))
    init = flatten_dict(jax.device_get({"params": jt.state.params,
                                        "batch_stats": jt.state.batch_stats}), sep="/")
    jax_losses = []
    step = jt._train_step_fn

    def recorded(*args):
        out = step(*args)
        jax_losses.append(float(out[3]))
        return out

    jt._train_step_fn = recorded
    jax_metrics = jt.fit(jdm)

    cfg = config(Config, "port")
    from waveformml_tpu_torch.config import validate_config

    validate_config(cfg)
    task = LitPSD(cfg, device="cpu")
    task.model.load_state_dict(flax_to_state_dict({k: np.asarray(v) for k, v in init.items()}))
    trainer = Trainer(cfg, task, device="cpu", max_epochs=2)
    metrics = trainer.fit(PSDDataModule(cfg))

    assert len(jax_losses) == len(trainer.step_losses) == 10
    np.testing.assert_allclose(trainer.step_losses, jax_losses, rtol=LOSS_RTOL)
    assert set(metrics) == set(jax_metrics) == {"train_loss", "train_accuracy", "val_loss",
                                                "val_accuracy"}


def test_half_serving_takes_float16_and_float32_feats():
    """InferenceModel under half_precision ships float16 features as they
    are and float32 ones as float32; both give the task's forward (the
    bf16 cast happens on the device)."""
    from waveformml_tpu_torch.inference.model import InferenceModel

    cfg = load_config(os.path.join(EXAMPLES, "SubMPSD.json"))
    cfg.system_config.half_precision = 1
    coords, feats = _half_chunk(6, 64)
    task = LitPSD(cfg, device="cpu")
    block = FileBlock(coords, feats, np.zeros(64, np.int64))
    db = task.to_device(task.prepare_block(block, task.row_bucket(block),
                                           task.event_bucket(block)))
    want = task.apply_model(db).numpy()[:64]
    server = InferenceModel(cfg, task.model.state_dict(), device="cpu")
    shipped = []
    prepare = server.task.prepare_block
    server.task.prepare_block = lambda blk, *a: shipped.append(blk.feats.dtype) or prepare(
        blk, *a)
    np.testing.assert_array_equal(server(coords, feats), want)
    # float32 features of float16 values round to the same bf16 values
    np.testing.assert_array_equal(server(coords, feats.astype(np.float32)), want)
    server(coords, feats.astype(np.float64))
    assert shipped == [np.float16, np.float32, np.float32]
