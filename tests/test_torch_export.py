"""The port's export of the eval forward against the JAX package's, on the
CPU: ``Trainer.export_model`` writes a ``torch.export`` program that
``load_exported`` reloads; with the JAX model's weights
(``convert.flax_to_state_dict``) it gives the JAX ``Trainer.export_model``'s
deserialized StableHLO program's outputs over the same block, and the
port's eager forward's, for a narrow SubMPSD, its ``half_precision`` form, a
narrow SegQuantifier and a narrow SingleEndedZCNN. The kernels are nodes of
their custom ops in the program; a batch of another row bucket is refused;
``python -m waveformml_tpu_torch.evaluate --script`` writes ``model.pt2``
into the log directory."""
import copy
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_evaluate import CFG as PSD_CFG
from test_torch_evaluate import N_SAMPLES

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the JAX export's own round-trip tolerance (tests/test_trainer.py)
JAX_RTOL, JAX_ATOL = 1e-4, 1e-6
#: the reloaded program against the port's eager forward
EAGER_RTOL, EAGER_ATOL = 1e-6, 1e-7


def _example(name):
    from waveformml_tpu_torch.config import load_config, to_dict

    d = to_dict(load_config(os.path.join(ROOT, "config", "examples", f"{name}.json")))
    d["system_config"]["n_samples"] = N_SAMPLES
    return d


def _psd(half):
    d = copy.deepcopy(PSD_CFG)
    d["system_config"]["half_precision"] = int(half)
    return d


def _block(key, rng, n_events=30):
    from waveformml_tpu_torch.datasets.synthetic import labelled_block, segment_block

    if key.startswith("SubMPSD"):
        block = labelled_block(rng, n_events, N_SAMPLES)
        if key == "SubMPSD-half":
            block.feats = block.feats.astype(np.float16)
        return block
    return segment_block(rng, n_events, N_SAMPLES, label="z" if key == "Z" else "ez")


#: case → (config dict maker, the custom ops its exported forward must call)
CASES = {
    "SubMPSD": (lambda: _psd(False), {"subm_conv_rows", "site_grouped_matmul"}),
    "SubMPSD-half": (lambda: _psd(True), {"subm_conv_rows", "site_grouped_matmul"}),
    "SegQuantifier": (lambda: _example("SegQuantifier"), {"subm_conv_rows"}),
    "Z": (lambda: _example("SingleEndedZCNN"), set()),
}


def _redraw(jt, seed):
    """Biases, BatchNorm scales and statistics of the JAX state redrawn
    (init leaves them trivial); returns the flat variables."""
    import jax
    import jax.numpy as jnp
    from flax.traverse_util import flatten_dict, unflatten_dict

    rng = np.random.default_rng(seed)
    flat = {}
    state = {"params": jt.state.params, "batch_stats": jt.state.batch_stats}
    for k, v in flatten_dict(jax.device_get(state), sep="/").items():
        v = np.asarray(v)
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


def _redraw_none(jt):
    """The JAX state's flat variables as they are."""
    import jax
    from flax.traverse_util import flatten_dict

    state = {"params": jt.state.params, "batch_stats": jt.state.batch_stats}
    return {k: np.asarray(v, np.float32)
            for k, v in flatten_dict(jax.device_get(state), sep="/").items()}


@pytest.fixture(scope="module", params=sorted(CASES))
def exported(request, tmp_path_factory):
    """One case: the JAX Trainer's StableHLO export and its outputs over a
    block, and the port's export of the same weights, reloaded."""
    import jax
    import jax.numpy as jnp
    from jax import export as jexport

    from waveformml_tpu.config import Config as JaxConfig
    from waveformml_tpu.datasets.hdf5_dataset import FileBlock as JaxFileBlock
    from waveformml_tpu.engineering import tasks as jtasks
    from waveformml_tpu.engineering.trainer import Trainer as JaxTrainer
    from waveformml_tpu.parallel.mesh import make_mesh

    from waveformml_tpu_torch.config import Config
    from waveformml_tpu_torch.convert import flax_to_state_dict
    from waveformml_tpu_torch.engineering import tasks
    from waveformml_tpu_torch.engineering.trainer import Trainer, load_exported

    key = request.param
    d = CASES[key][0]()
    block = _block(key, np.random.default_rng(41))
    jblock = JaxFileBlock(block.coords, block.feats, block.labels, {})
    jcfg = JaxConfig(copy.deepcopy(d))
    run_class = d["run_config"]["run_class"]
    jt = JaxTrainer(jcfg, getattr(jtasks, run_class)(jcfg), mesh=make_mesh(jax.devices()[:1]),
                    seed=0, callbacks=[])
    jt._ensure_state(jblock)
    # the Z net ends in a ReLU that the redrawn statistics close everywhere:
    # it keeps its initial weights
    flat = _redraw(jt, 42) if key != "Z" else _redraw_none(jt)
    tmp = tmp_path_factory.mktemp(key)
    jpath = jt.export_model(str(tmp / "model.stablehlo"), jblock)
    one = {k: jnp.asarray(v[0]) for k, v in jt._device_batch(jblock).items()}
    jax_out = np.asarray(jexport.deserialize(open(jpath, "rb").read()).call(one))

    cfg = Config(copy.deepcopy(d))
    task = getattr(tasks, run_class)(cfg, device="cpu")
    task.model.load_state_dict(flax_to_state_dict(flat))
    trainer = Trainer(cfg, task, "cpu")
    path = trainer.export_model(str(tmp / "model.pt2"), block)
    db = trainer.device_batch(block)[0]
    assert sorted(db) == sorted(one)
    return dict(key=key, path=path, db=db, block=block, trainer=trainer, jax_out=jax_out,
                run=load_exported(path, "cpu"), ops=CASES[key][1])


def test_reloaded_program_matches_the_jax_export(exported):
    got = exported["run"](exported["db"]).numpy()
    want = exported["jax_out"]
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    assert np.abs(want).max() > 1e-3
    np.testing.assert_allclose(got, want, rtol=JAX_RTOL, atol=JAX_ATOL)


def test_reloaded_program_matches_the_eager_forward(exported):
    task = exported["trainer"].task
    # the export put the model back in the mode it found it in
    assert task.model.training
    got = exported["run"](exported["db"])
    want = task.apply_model(exported["db"])
    torch.testing.assert_close(got, want, rtol=EAGER_RTOL, atol=EAGER_ATOL)


def test_exported_graph_calls_the_kernels_as_custom_ops(exported):
    program = torch.export.load(exported["path"])
    ours = [str(n.target) for n in program.graph.nodes
            if n.op == "call_function" and str(n.target).startswith("waveformml.")]
    assert {t.split(".")[1] for t in ours} == exported["ops"]
    if exported["ops"]:
        # one K1 node per row conv of the stack
        n_convs = sum(1 for m in exported["trainer"].task.model.modules()
                      if type(m).__name__ == "RowSubMConv2d")
        assert ours.count("waveformml.subm_conv_rows.default") == n_convs > 0


def test_batch_of_another_bucket_raises(exported):
    """The program has the static shapes of the block it was traced on."""
    trainer = exported["trainer"]
    bigger = _block(exported["key"], np.random.default_rng(43), n_events=400)
    db = trainer.device_batch(bigger)[0]
    assert db["mask"].shape != exported["db"]["mask"].shape
    with pytest.raises(Exception):
        exported["run"](db)


def test_export_of_a_packed_batch(exported, tmp_path, monkeypatch):
    """On the card a device batch is views of one packed buffer in several
    dtypes (``unpack_db``); the program still saves and reloads."""
    from waveformml_tpu_torch.engineering.base import pack_db, unpack_db
    from waveformml_tpu_torch.engineering.trainer import load_exported

    trainer = exported["trainer"]
    monkeypatch.setattr(trainer.task, "to_device", lambda db: unpack_db(*pack_db(db)))
    db = trainer.device_batch(exported["block"])[0]
    assert len({v.untyped_storage().data_ptr() for v in db.values()}) == 1
    path = trainer.export_model(str(tmp_path / "packed.pt2"), exported["block"])
    torch.testing.assert_close(load_exported(path, "cpu")(db), exported["run"](exported["db"]),
                               rtol=0, atol=0)


def test_load_exported_refuses_another_device(exported):
    from waveformml_tpu_torch.engineering.trainer import load_exported

    with pytest.raises(ValueError, match="exported on"):
        load_exported(exported["path"], "meta")


def test_evaluate_module_script_writes_model_pt2(tmp_path):
    """``--script`` writes ``model.pt2`` into ``log_dir_for(checkpoint)``
    before the test pass; reloaded, it gives the checkpoint's eager
    forward over the first test block."""
    from waveformml_tpu_torch.config import load_config
    from waveformml_tpu_torch.datasets.synthetic import write_classification_dirs
    from waveformml_tpu_torch.engineering.tasks import LitPSD
    from waveformml_tpu_torch.engineering.trainer import Trainer, _take, load_exported
    from waveformml_tpu_torch.evaluate import log_dir_for
    from waveformml_tpu_torch.main import choose_data_module

    write_classification_dirs(str(tmp_path / "data"), ["Ioni", "Recoil"], n_files=4,
                              events_per_file=20, n_samples=N_SAMPLES, seed=7)
    with open(os.path.join(ROOT, "config", "examples", "SubMPSD.json")) as f:
        cfg = json.load(f)
    cfg["system_config"].update(n_samples=N_SAMPLES, model_base_path=str(tmp_path / "model"))
    cfg["dataset_config"].update(base_path=str(tmp_path / "data"), n_train=40, n_validate=20,
                                 n_test=20, shuffled_size=20,
                                 dataloader_params={"batch_size": 1, "num_workers": 0})
    path = str(tmp_path / "SubMPSD.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    config = load_config(path)
    ckpt = str(tmp_path / "ckpt" / "epoch=0-val_loss=0.69.ckpt")
    os.makedirs(os.path.dirname(ckpt))
    trainer = Trainer(config, LitPSD(config, "cpu"), "cpu")
    trainer.save_checkpoint(ckpt)

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-m", "waveformml_tpu_torch.evaluate", path, ckpt,
                           "--script", "--limit_test_batches", "1", "--device", "cpu",
                           "-nt", "2"], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    exported_to = os.path.join(log_dir_for(ckpt), "model.pt2")
    assert exported_to in proc.stdout + proc.stderr
    assert "test:" in proc.stdout

    dm = choose_data_module(config)
    dm.setup("test")
    first = next(iter(_take(dm.test_dataloader(), 1)))
    db = trainer.device_batch(first)[0]
    torch.testing.assert_close(load_exported(exported_to, "cpu")(db),
                               trainer.task.apply_model(db), rtol=EAGER_RTOL,
                               atol=EAGER_ATOL)
