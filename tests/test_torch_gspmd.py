"""Tensor-parallel (the JAX package's GSPMD dp×tp engine) training of the
port on the CPU: ranks are processes (``tests/_torch_dist_worker.py``)
joined by ``torch.distributed`` over Gloo with a ``file://`` rendezvous
in the test's directory, one thread each; every spawn has its own
timeout, after which its ranks are killed. The module fixture starts
three spawns at once and waits for each: four ranks on a (2, 2) grid over
every dp×tp case and the column functions' checks, two ranks on a (1, 2)
grid (where tests/test_gspmd.py runs two processes), and four ranks of
the CLI.

The counterpart of tests/test_gspmd.py's nine tests, one for one: the
(2, 2) step against one rank and the JAX gspmd ``Trainer``; fit and
test; the checkpoint round trip; a row-label ``LitZ`` task; a bf16 step
with float32 master parameters; a tp checkpoint served by a one-device
``InferenceModel``; the (1, 2) step, evaluator figures and graph step.
Each (2, 2) case trains on ``split_block_for_devices(B, 2)[d]`` at data
index d (the Trainer reads the shards round-robin over the data index)
from the same weights as one rank on B: per-step losses, parameters and
running statistics within rtol 1e-5, atol 1e-6; the JAX ``Trainer`` with
``tp=2`` on ``make_mesh_2d(jax.devices()[:4], dp=2, tp=2)`` (this
process's JAX has 8 virtual CPU devices) within the trajectory tolerance
rtol 2e-3, atol 2e-4; the flax names the port shards equal to those the
JAX rule shards. Unit tests hold ``tp_spec_for`` and the rank → (data,
model) map to the JAX package's, and the column functions' gradients,
the replicated bias's gradient, the global-norm clip and a
``shard_params``/``gather_params`` round trip to one rank's arithmetic.
"""
import copy
import glob
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from waveformml_tpu_torch.config import Config
from waveformml_tpu_torch.convert import flax_to_state_dict
from waveformml_tpu_torch.datasets.hdf5_dataset import FileBlock
from waveformml_tpu_torch.datasets.synthetic import (BlockDataModule, labelled_block,
                                                     waveform_block)
from waveformml_tpu_torch.engineering.trainer import Trainer, _rank_seed
from waveformml_tpu_torch.inference.model import InferenceModel
from waveformml_tpu_torch.parallel.gspmd import mesh_coords, sharded_flax_names, tp_spec_for
from waveformml_tpu_torch.parallel.mesh import split_block_for_devices
from waveformml_tpu_torch.registry import retrieve_class

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)
sys.path.insert(0, TESTS)
from _dist_train_common import make_graph_cfg_block  # noqa: E402

DP, TP = 2, 2
STEPS = 3
N_SAMPLES = 16
RTOL, ATOL = 1e-5, 1e-6
JAX_RTOL, JAX_ATOL = 2e-3, 2e-4
HALF_LOSS_RTOL = 1e-3
#: seconds a spawn of ranks may take before its ranks are killed
TIMEOUT = 240


def _psd_config(**system) -> dict:
    """tests/test_gspmd.py's SubMPSDNet (16 samples, out_planes 16, two
    Linear layers): the rule shards its first conv ([9, 32, 26]), its k=1
    conv ([1, 21, 16]) and the head ([16·154, 70])."""
    return {
        "run_config": {"exp_name": "g", "run_class": "LitPSD", "imports": []},
        "system_config": {"model_name": "g", "n_samples": N_SAMPLES, "n_type": 2,
                          "type_names": ["TypeA", "TypeB"], "model_base_path": "/tmp/g",
                          "gpu_enabled": False, "half_precision": 0, **system},
        "net_config": {"criterion_class": "CrossEntropyLoss", "criterion_params": [],
                       "imports": [], "net_class": "SubMPSDNet",
                       "net_type": "2DConvolution",
                       "hparams": {"out_planes": 16, "n_lin": 2,
                                   "conv_params": {"kernel_size": 3, "n_conv": 2,
                                                   "n_point": 1, "conv_position": 1,
                                                   "version": 2}}},
        "optimize_config": {"total_epoch": 1, "lr": 0.05, "validation_freq": 1,
                            "imports": [], "optimizer_class": "optim.SGD",
                            "optimizer_params": {"momentum": 0.9, "nesterov": True}},
        "dataset_config": {"mode": "path", "imports": [], "paths": ["TypeA", "TypeB"],
                           "dataset_class": "PulseDataset2D", "dataset_params": {},
                           "n_train": 1, "n_validate": 1}}


def _litz_config() -> dict:
    """tests/test_gspmd.py's row-label LitZ (``algorithm: "conv"``): the
    rule shards its grid conv's kernel ([3, 3, 32, 16])."""
    return {
        "run_config": {"exp_name": "gz", "run_class": "LitZ", "imports": []},
        "system_config": {"model_name": "gz", "n_samples": N_SAMPLES, "n_type": 2,
                          "type_names": ["a"], "model_base_path": "/tmp/gz",
                          "half_precision": 0},
        "net_config": {"criterion_class": "L1Loss", "criterion_params": [],
                       "imports": [], "net_type": "2DConvolution", "algorithm": "conv",
                       "hparams": {"conv": {"kernel_size": 3, "n_layers": 2},
                                   "point": {"pointwise_layers": 1}}},
        "optimize_config": {"total_epoch": 1, "lr": 0.01, "validation_freq": 1,
                            "imports": [], "optimizer_class": "optim.SGD",
                            "optimizer_params": {}},
        "dataset_config": {"mode": "path", "imports": [], "paths": ["a"],
                           "dataset_class": "PulseDatasetWFPair", "dataset_params": {},
                           "n_train": 8, "n_validate": 4}}


def _graph_config() -> dict:
    """make_graph_cfg_block's GraphNet at 16 graph features: the rule
    shards both convs' Linear layers ([16, 16])."""
    from waveformml_tpu.config import to_dict

    d = copy.deepcopy(to_dict(make_graph_cfg_block()[0]))
    d["net_config"]["hparams"]["graph_out"] = 16
    return d


def _rnn_config() -> dict:
    """SingleWaveformRNN.json at 12 samples: the rule shards both ReLU
    cells' kernels and the first Linear layer."""
    from waveformml_tpu_torch.config import load_config, to_dict

    d = to_dict(load_config(os.path.join(ROOT, "config", "examples",
                                         "SingleWaveformRNN.json")))
    d["system_config"]["n_samples"] = 12
    return d


def _tcn_config() -> dict:
    """SingleWaveformTCN.json at 12 samples, expanded 16-fold: the rule
    shards the middle block's weight-normed convs ([3, 16, 32] and [3,
    32, 32] in flax) and its 1×1 downsample, whose parent reads the
    weight directly."""
    from waveformml_tpu_torch.config import load_config, to_dict

    d = to_dict(load_config(os.path.join(ROOT, "config", "examples",
                                         "SingleWaveformTCN.json")))
    d["system_config"]["n_samples"] = 12
    d["net_config"]["hparams"].update(n_expand=2, expansion_factor=16)
    return d


def _litz_block() -> FileBlock:
    rng = np.random.default_rng(0)
    n = 24
    coords = np.stack([rng.integers(0, 14, n), rng.integers(0, 11, n),
                       np.sort(rng.integers(0, 12, n))], axis=1).astype(np.int32)
    return FileBlock(coords, rng.random((n, 2 * N_SAMPLES)).astype(np.float32),
                     rng.random(n).astype(np.float32), {})


def _graph_block() -> FileBlock:
    b = make_graph_cfg_block()[1]
    return FileBlock(b.coords, b.feats, b.labels, {})


def _psd_block(seed: int, n_events: int = 16) -> FileBlock:
    return labelled_block(np.random.default_rng(seed), n_events, N_SAMPLES)


def _seeded_init(d: dict, seed: int) -> dict:
    cfg = Config(copy.deepcopy(d))
    torch.manual_seed(seed)
    return {k: v.numpy() for k, v in
            retrieve_class(cfg.run_config.run_class)(cfg, "cpu").model.state_dict().items()}


# -- the JAX package ---------------------------------------------------------------------

def _jax_flat(jt) -> dict:
    from flax.traverse_util import flatten_dict
    import jax

    tree = {"params": jt.state.params}
    if jt.state.batch_stats:
        tree["batch_stats"] = jt.state.batch_stats
    return {k: np.asarray(v) for k, v in flatten_dict(jax.device_get(tree), sep="/").items()}


def _jax_trainer(d: dict, block: FileBlock, tp: int):
    """The JAX Trainer, with ``tp = 2`` on the (2, 2) mesh of 4 devices
    (its gspmd engine), else on one device; its state built from ``block``."""
    import jax

    from waveformml_tpu.config import Config as JaxConfig
    from waveformml_tpu.datasets.hdf5_dataset import FileBlock as JaxFileBlock
    from waveformml_tpu.engineering.trainer import Trainer as JaxTrainer
    from waveformml_tpu.parallel.gspmd import make_mesh_2d
    from waveformml_tpu.parallel.mesh import make_mesh
    from waveformml_tpu.registry import retrieve_class as jax_class

    jcfg = JaxConfig(copy.deepcopy(d))
    mesh = (make_mesh_2d(jax.devices()[:DP * TP], dp=DP, tp=TP) if tp > 1
            else make_mesh(jax.devices()[:1]))
    jt = JaxTrainer(jcfg, jax_class(jcfg.run_config.run_class)(jcfg), mesh=mesh, tp=tp,
                    seed=0, callbacks=[])
    jb = JaxFileBlock(block.coords, block.feats, block.labels, dict(block.extras))
    jt._ensure_state(jb)
    return jt, jb


def _jax_sharded_names(jt) -> list:
    """The flax names of the JAX Trainer's parameters that its rule shards."""
    from waveformml_tpu.parallel.gspmd import tp_spec_for as jax_tp_spec_for

    return sorted(k for k, v in _jax_flat(jt).items()
                  if k.startswith("params/") and tuple(jax_tp_spec_for(v.shape, TP)))


def _jax_gspmd_trajectory(d: dict, block: FileBlock):
    """STEPS steps of the JAX gspmd Trainer on ``block``: the initial
    weights as a port state dict, the sharded flax names, the step losses,
    the final state."""
    import jax

    jt, jb = _jax_trainer(d, block, TP)
    assert jt.mesh.shape == {"data": DP, "model": TP}
    init = {k: v.numpy() for k, v in flax_to_state_dict(_jax_flat(jt)).items()}
    names = _jax_sharded_names(jt)
    losses = []
    for i in range(STEPS):
        db = jt._to_device(jt._device_batch(jb))
        st = jt.state
        st.params, st.batch_stats, st.opt_state, loss, _ = jt._train_step_fn(
            st.params, st.batch_stats, st.opt_state, jax.random.PRNGKey(i), db)
        losses.append(float(loss))
    final = {k: v.numpy() for k, v in flax_to_state_dict(_jax_flat(jt)).items()}
    return init, names, losses, final


# -- the port on one rank ----------------------------------------------------------------

def _one_rank(d: dict, init: dict, train, val=(), test=(), load=None, restore=False,
              **kwargs):
    cfg = Config(copy.deepcopy(d))
    task = retrieve_class(cfg.run_config.run_class)(cfg, "cpu")
    task.model.load_state_dict({k: torch.as_tensor(v) for k, v in init.items()})
    trainer = Trainer(cfg, task, device="cpu", callbacks=[], **kwargs)
    if load:
        trainer.load_checkpoint(load, restore_training=restore)
    dm = BlockDataModule(train, val, test)
    fit = trainer.fit(dm)
    out = {"losses": list(trainer.step_losses), "fit": fit,
           "state": {k: v.numpy() for k, v in task.model.state_dict().items()},
           "model": task.model}
    if test:
        out["test"] = trainer.test(dm)
    return out


# -- spawning ranks ----------------------------------------------------------------------

def _start(args_of_rank, n: int, cwd):
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    return [subprocess.Popen([sys.executable, *args_of_rank(r)], cwd=str(cwd), env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(n)]


def _wait(procs, timeout=TIMEOUT):
    """Each rank's output, each rank waited for at most ``timeout`` seconds,
    every rank killed after a timeout; asserts each exited 0."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-6000:]
    return outs


def _job(tmp, name: str, cases: dict, units: bool = False) -> str:
    path = str(tmp / name)
    with open(path, "wb") as f:
        pickle.dump({"init_method": f"file://{tmp}/{name}.rendezvous", "cases": cases,
                     "units": units}, f)
    return path


def _results(job: str, n: int) -> list:
    out = []
    for r in range(n):
        with open(f"{job}.rank{r}", "rb") as f:
            out.append(pickle.load(f))
    return out


def _cli_config(tmp) -> str:
    from waveformml_tpu_torch.datasets.synthetic import write_classification_dirs

    write_classification_dirs(str(tmp / "data"), ["Ioni", "Recoil"], n_files=4,
                              events_per_file=20, n_samples=8, seed=5)
    with open(os.path.join(ROOT, "config", "examples", "SubMPSD.json")) as f:
        cfg = json.load(f)
    cfg["system_config"].update(n_samples=8, model_base_path=str(tmp / "model"))
    # every rank would write the offline shuffle's files: none here
    cfg["dataset_config"].pop("data_prep")
    cfg["dataset_config"].update(base_path=str(tmp / "data"), n_train=40, n_validate=20,
                                 n_test=20,
                                 dataloader_params={"batch_size": 1, "num_workers": 0})
    path = str(tmp / "SubMPSD.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


#: the (2, 2) cases held to one rank and to the JAX gspmd Trainer
JAX_CASES = ("psd", "litz", "graph")
#: the (2, 2) cases held to one rank
CASES = JAX_CASES + ("rnn", "tcn")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case through one rank (and the JAX gspmd Trainer), and through
    the three spawns, started together: (2, 2), (1, 2) and the CLI."""
    tmp = tmp_path_factory.mktemp("tp")
    worker = os.path.join(TESTS, "_torch_dist_worker.py")
    blocks = {"psd": _psd_block(1), "litz": _litz_block(), "graph": _graph_block(),
              "rnn": waveform_block(np.random.default_rng(2), 24, 12),
              "tcn": waveform_block(np.random.default_rng(3), 24, 12)}
    configs = {"psd": _psd_config(), "litz": _litz_config(), "graph": _graph_config(),
               "rnn": _rnn_config(), "tcn": _tcn_config()}
    jax_runs = {name: _jax_gspmd_trajectory(configs[name], blocks[name])
                for name in JAX_CASES}
    inits = {name: jax_runs[name][0] if name in jax_runs else _seeded_init(configs[name], 3)
             for name in CASES}

    grid, ckpt = {}, str(tmp / "fit_test.ckpt")
    for name in CASES:
        shards = split_block_for_devices(blocks[name], DP)
        grid[name] = {"config": configs[name], "init": inits[name],
                      "trainer": {"tp": TP, "parallel": "gspmd"},
                      "train": shards * STEPS, "val": shards}
    half = _psd_config(half_precision=1)
    psd_shards = split_block_for_devices(blocks["psd"], DP)
    grid["bf16"] = {"config": half, "init": _seeded_init(half, 4), "trainer": {"tp": TP},
                    "train": psd_shards, "val": psd_shards}
    fit_blocks = [_psd_block(10 + i, 8) for i in range(10)]
    fit_cfg = _psd_config()
    fit_cfg["optimize_config"]["total_epoch"] = 2
    # each data rank reads its half of every block (the shards in turn)
    split = lambda bs: [s for b in bs for s in split_block_for_devices(b, DP)]  # noqa: E731
    fit_case = {"config": fit_cfg, "init": _seeded_init(fit_cfg, 5),
                "train": split(fit_blocks[:5]), "val": split(fit_blocks[5:7]),
                "test": split(fit_blocks[7:]), "save": ckpt,
                "trainer": {"tp": TP, "checkpoint_dir": str(tmp / "best"),
                            "early_stopping_patience": 10}}
    grid["fit_test"] = fit_case
    grid["resume"] = {"config": fit_cfg, "init": fit_case["init"], "load": ckpt,
                      "restore": True, "train": split(fit_blocks[:4]),
                      "val": split(fit_blocks[5:7]),
                      "trainer": {"tp": TP, "max_epochs": 3}}

    pair_init = _seeded_init(_psd_config(), 6)
    pair = {"step": {"config": _psd_config(), "init": pair_init, "trainer": {"tp": TP},
                     "train": [blocks["psd"]], "val": [blocks["psd"]]},
            "evaluator": {"config": _psd_config(), "init": pair_init,
                          "trainer": {"tp": TP}, "train": [], "test": [blocks["psd"]],
                          "evaluator": True},
            "graph": {"config": _graph_config(), "init": inits["graph"],
                      "trainer": {"tp": TP}, "train": [blocks["graph"]],
                      "val": [blocks["graph"]]}}

    cli_dir = tmp / "cli"
    cli_dir.mkdir()
    cli_path = _cli_config(cli_dir)
    jobs = {"grid": _job(tmp, "grid", grid, units=True), "pair": _job(tmp, "pair", pair)}
    spawns = {"grid": _start(lambda r: [worker, jobs["grid"], str(r), str(DP * TP)],
                             DP * TP, tmp),
              "pair": _start(lambda r: [worker, jobs["pair"], str(r), str(TP)], TP, tmp),
              "cli": _start(lambda r: ["-m", "waveformml_tpu_torch.main", cli_path, "-t",
                                       "--max_epochs", "2", "-v", "2", "--device", "cpu",
                                       "--distributed", "--coordinator",
                                       f"file://{cli_dir}/rendezvous", "--num_processes",
                                       str(DP * TP), "--process_id", str(r),
                                       "--parallel", "gspmd", "--tp", str(TP)],
                            DP * TP, cli_dir)}
    # the references run while the ranks do
    one = {}
    for name in CASES:
        one[name] = _one_rank(configs[name], inits[name], [blocks[name]] * STEPS,
                              [blocks[name]])
    one["bf16"] = _one_rank(half, grid["bf16"]["init"], [blocks["psd"]], [blocks["psd"]])
    one["fit_test"] = _one_rank(fit_cfg, fit_case["init"], fit_blocks[:5], fit_blocks[5:7],
                                fit_blocks[7:], early_stopping_patience=10)
    one["step"] = _one_rank(_psd_config(), pair_init, [blocks["psd"]], [blocks["psd"]])
    one["pair_graph"] = _one_rank(_graph_config(), inits["graph"], [blocks["graph"]],
                                  [blocks["graph"]])
    outs = {name: _wait(procs) for name, procs in spawns.items()}
    one["resume"] = _one_rank(fit_cfg, fit_case["init"], fit_blocks[:4], fit_blocks[5:7],
                              load=ckpt, restore=True, max_epochs=3)
    return {"one": one, "jax": jax_runs, "grid": _results(jobs["grid"], DP * TP),
            "pair": _results(jobs["pair"], TP), "cli": outs["cli"], "cli_dir": cli_dir,
            "ckpt": ckpt, "configs": configs, "blocks": blocks, "fit_cfg": fit_cfg,
            "fit_case": fit_case, "fit_blocks": fit_blocks}


def _assert_state(got: dict, want: dict, rtol: float, atol: float) -> None:
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=rtol, atol=atol, err_msg=k)


# -- the JAX package's rule and mesh -------------------------------------------------------

@pytest.mark.parametrize("shape", [(16,), (4, 16), (3, 3, 32, 26), (9, 130, 104),
                                   (1232, 50), (1232, 15), (16, 14), (8, 7), (2, 2, 4, 24),
                                   (9, 104, 56), (56, 8), (50, 2)])
@pytest.mark.parametrize("tp", [1, 2, 4])
def test_tp_spec_for_matches_jax(shape, tp):
    from waveformml_tpu.parallel.gspmd import tp_spec_for as jax_tp_spec_for

    assert tp_spec_for(shape, tp) == tuple(jax_tp_spec_for(shape, tp))


@pytest.mark.parametrize("dp, tp", [(2, 2), (4, 2), (1, 2), (2, 4), (8, 1)])
def test_rank_coordinates_match_jax_mesh(dp, tp):
    """Rank r sits where ``make_mesh_2d`` puts device r."""
    import jax

    from waveformml_tpu.parallel.gspmd import make_mesh_2d

    devices = jax.devices()[:dp * tp]
    mesh = make_mesh_2d(devices, dp=dp, tp=tp)
    for r, dev in enumerate(devices):
        d, m = (int(i) for i in np.argwhere(mesh.devices == dev)[0])
        assert mesh_coords(r, tp) == (d, m)


@pytest.mark.parametrize("name", CASES)
def test_sharded_names_match_jax(runs, name):
    """The port shards the parameters whose flax names the JAX rule shards,
    and at least one."""
    if name in runs["jax"]:
        want = runs["jax"][name][1]
    else:
        jt, _ = _jax_trainer(runs["configs"][name], runs["blocks"][name], 1)
        want = _jax_sharded_names(jt)
    got = sharded_flax_names(runs["one"][name]["model"], TP)
    assert got and got == want


# -- the column functions ----------------------------------------------------------------

def _units(runs) -> list:
    return [r["units"] for r in runs["grid"]]


def test_column_pair_gradients_match_one_rank(runs):
    """``gather_from_model(copy_to_model(x) @ w_block)``: the output and x's
    gradient equal one rank's on the whole w on every rank, and each
    rank's weight gradient is its block of one rank's."""
    x, w, g = _unit_inputs()
    xs, ws = x.clone().requires_grad_(), w.clone().requires_grad_()
    y = xs @ ws
    y.backward(g)
    for u in _units(runs):
        m = u["mesh"][1]
        got_y, got_dx, got_dw = u["pair"]
        torch.testing.assert_close(got_y, y.detach(), rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(got_dx, xs.grad, rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(got_dw, ws.grad[:, m * 8:(m + 1) * 8], rtol=1e-12,
                                   atol=1e-12)


def test_column_linear_bias_gradient_equals_one_rank(runs):
    """``column_linear``: the replicated bias, added after the gather, gets
    one rank's whole gradient on every rank of the grid."""
    x, w, g = _unit_inputs()
    b = _unit_bias()
    xs, bs = x.clone().requires_grad_(), b.clone().requires_grad_()
    ws = w.t().contiguous().requires_grad_()
    y = torch.nn.functional.linear(xs, ws, bs)
    y.backward(g)
    for u in _units(runs):
        m = u["mesh"][1]
        got_y, got_dx, got_dw, got_db = u["linear"]
        torch.testing.assert_close(got_y, y.detach(), rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(got_dx, xs.grad, rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(got_dw, ws.grad[m * 8:(m + 1) * 8], rtol=1e-12,
                                   atol=1e-12)
        torch.testing.assert_close(got_db, bs.grad, rtol=0, atol=0)


def test_gather_weight_blocks_of_gates(runs):
    """``gather_weight`` of a [3·8, 6] parameter in three gate blocks: the
    whole tensor on every rank, and each rank's gradient its columns of
    every gate."""
    full, gw = _unit_gates()
    for u in _units(runs):
        m = u["mesh"][1]
        whole, grad = u["gather_weight"]
        torch.testing.assert_close(whole, full, rtol=0, atol=0)
        want = torch.cat([gw[gate * 8 + m * 4:gate * 8 + (m + 1) * 4] for gate in range(3)])
        torch.testing.assert_close(grad, want, rtol=0, atol=0)


def test_global_norm_clip_counts_each_block_once(runs):
    """The clip of a sharded gradient (this rank's columns) and a
    replicated one: one rank's norm and clipped gradients."""
    _, _, g = _unit_inputs()
    b = _unit_bias()
    from waveformml_tpu_torch.optim import clip_by_global_norm_

    grads = [g.clone(), b.clone()]
    norm = clip_by_global_norm_(grads, 1.0)
    assert float(norm) > 1.0                 # the clip engages
    for u in _units(runs):
        m = u["mesh"][1]
        got_norm, got_block, got_rep = u["clip"]
        torch.testing.assert_close(got_norm, norm, rtol=1e-12, atol=0)
        torch.testing.assert_close(got_block, grads[0][:, m * 8:(m + 1) * 8], rtol=1e-12,
                                   atol=0)
        torch.testing.assert_close(got_rep, grads[1], rtol=1e-12, atol=0)


def test_shard_then_gather_round_trips_exactly(runs):
    """``shard_params`` then ``gather_params`` gives the one-rank state
    back bit for bit: a sharded Linear, a GRU sharded by gate, replicated
    leaves; the blocks are the shards' shapes."""
    for u in _units(runs):
        full, back, specs, shapes = u["roundtrip"]
        assert specs == ["cell_0.weight_hh_l0", "cell_0.weight_ih_l0", "dense_0.weight"]
        assert shapes["dense_0.weight"] == (8, 6)
        assert shapes["cell_0.weight_ih_l0"] == (24, 6)
        assert shapes["dense_1.weight"] == (2, 16)
        assert sorted(back) == sorted(full)
        for k, v in full.items():
            assert torch.equal(back[k], v), k


def _unit_inputs():
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(5, 6, generator=gen, dtype=torch.float64)
    w = torch.randn(6, 16, generator=gen, dtype=torch.float64)
    torch.randn(16, generator=gen, dtype=torch.float64)
    g = torch.randn(5, 16, generator=gen, dtype=torch.float64)
    return x, w, g


def _unit_bias():
    gen = torch.Generator().manual_seed(3)
    torch.randn(5, 6, generator=gen, dtype=torch.float64)
    torch.randn(6, 16, generator=gen, dtype=torch.float64)
    return torch.randn(16, generator=gen, dtype=torch.float64)


def _unit_gates():
    gen = torch.Generator().manual_seed(3)
    for shape in ((5, 6), (6, 16), (16,), (5, 16)):
        torch.randn(*shape, generator=gen, dtype=torch.float64)
    return (torch.randn(24, 6, generator=gen, dtype=torch.float64),
            torch.randn(24, 6, generator=gen, dtype=torch.float64))


# -- the (2, 2) grid ---------------------------------------------------------------------

def test_grid_places_and_dropout_seeds(runs):
    """Rank r at (r // 2, r % 2) of a (2, 2) mesh, with the blocks of its
    sharded parameters; the dropout stream seeded with the data index, so
    that a model group draws one mask."""
    for r, res in enumerate(runs["grid"]):
        case = res["psd"]
        assert case["mesh"] == {"data": DP, "model": TP}
        assert (case["data_index"], case["model_index"]) == mesh_coords(r, TP)
        assert case["seed"] == _rank_seed(0, r // TP)
        assert case["blocks"] == {"stack.l0.weight": (9, 32, 13),
                                  "stack.l6.weight": (1, 21, 8), "head0.weight": (2464, 35)}
    assert runs["grid"][0]["psd"]["seed"] == 0


@pytest.mark.parametrize("name", CASES)
def test_dp_tp_matches_one_rank(runs, name):
    """Every rank steps with the losses, and ends with the parameters and
    running statistics, of one rank over the whole blocks; the validation
    loss too."""
    one = runs["one"][name]
    for res in runs["grid"]:
        got = res[name]
        assert got["world_size"] == DP * TP
        np.testing.assert_allclose(got["step_losses"], one["losses"], rtol=RTOL, atol=ATOL)
        _assert_state(got["state"], one["state"], RTOL, ATOL)
        for k, v in one["fit"].items():
            assert got["fit"][k] == pytest.approx(v, rel=RTOL, abs=ATOL), k


@pytest.mark.parametrize("name", JAX_CASES)
def test_dp_tp_matches_jax_gspmd(runs, name):
    """The JAX gspmd Trainer on the (2, 2) mesh: the same losses,
    parameters and running statistics after 3 steps (the row-label LitZ
    task included)."""
    _, _, jax_losses, jax_state = runs["jax"][name]
    for res in runs["grid"]:
        got = res[name]
        np.testing.assert_allclose(got["step_losses"], jax_losses, rtol=JAX_RTOL,
                                   atol=JAX_ATOL)
        _assert_state(got["state"], jax_state, JAX_RTOL, JAX_ATOL)


def test_bf16_step_keeps_float32_master_params(runs):
    """half_precision under tp: the loss of one rank (the half-precision
    tolerance), float32 parameters."""
    one = runs["one"]["bf16"]
    for res in runs["grid"]:
        got = res["bf16"]
        assert np.isfinite(got["step_losses"]).all()
        np.testing.assert_allclose(got["step_losses"], one["losses"], rtol=HALF_LOSS_RTOL)
        assert all(v.dtype == np.float32 for v in got["state"].values()
                   if v.dtype.kind == "f")


def test_fit_and_test_end_to_end(runs):
    """(2, 2) ranks fit 2 epochs over 5 training blocks, each data rank on
    its half of each, with 2 validation blocks, and test 3: the same
    metrics on every rank, one rank's metrics over the whole blocks, one
    best checkpoint; only model-index-0 ranks collect (3 half blocks of 4
    events each)."""
    one = runs["one"]["fit_test"]
    res = [r["fit_test"] for r in runs["grid"]]
    assert all(r["fit"] == res[0]["fit"] and r["test"] == res[0]["test"] for r in res)
    assert len(res[0]["step_losses"]) == 2 * 5
    np.testing.assert_allclose(res[0]["step_losses"], one["losses"], rtol=RTOL, atol=ATOL)
    for k, v in one["fit"].items():
        assert res[0]["fit"][k] == pytest.approx(v, rel=RTOL, abs=ATOL), k
    for k, v in one["test"].items():
        assert res[0]["test"][k] == pytest.approx(v, rel=RTOL, abs=ATOL), k
    assert [len(r["collected"]) for r in res] == [3, 0, 3, 0]
    assert all(c == (4, 4) for r in res for c in r["collected"])
    assert [r["logger"] for r in res] == [True, False, False, False]
    ckpts = glob.glob(os.path.join(runs["fit_case"]["trainer"]["checkpoint_dir"], "*.ckpt"))
    assert len(ckpts) == 1 and all(r["best_ckpt_path"] == ckpts[0] for r in res)


def test_checkpoint_roundtrip(runs):
    """A tp checkpoint is the one-rank file (its keys and shapes); loaded
    onto (2, 2) ranks it is the saved state, sharded as the rule says, and
    resuming from it steps as one rank resuming does."""
    ckpt = torch.load(runs["ckpt"], weights_only=True)
    one = runs["one"]["fit_test"]
    assert {k: tuple(v.shape) for k, v in ckpt["state_dict"].items()} == {
        k: v.shape for k, v in one["state"].items()}
    saved = {k: v.numpy() for k, v in ckpt["state_dict"].items()}
    _assert_state(runs["grid"][0]["fit_test"]["state"], saved, 0, 0)
    one_resume = runs["one"]["resume"]
    for res in runs["grid"]:
        got = res["resume"]
        _assert_state(got["loaded"], saved, 0, 0)
        assert got["blocks"]["head0.weight"] == (2464, 35)
        assert len(got["step_losses"]) == 4
        np.testing.assert_allclose(got["step_losses"], one_resume["losses"], rtol=RTOL,
                                   atol=ATOL)
        _assert_state(got["state"], one_resume["state"], RTOL, ATOL)


def test_checkpoint_serves_single_device(runs):
    """Train on ranks, serve on one device: the tp checkpoint loads into a
    one-rank Trainer and into ``InferenceModel``, which score the test
    blocks alike."""
    cfg = Config(copy.deepcopy(runs["fit_cfg"]))
    trainer = Trainer(cfg, retrieve_class("LitPSD")(cfg, "cpu"), device="cpu", callbacks=[])
    trainer.load_checkpoint(runs["ckpt"])
    block = runs["fit_blocks"][7]
    db = trainer.task.to_device(trainer.task.prepare_block(
        block, trainer.task.row_bucket(block), trainer.task.event_bucket(block)))
    with torch.no_grad():
        trainer.task.model.eval()
        want = trainer.task.forward_model(db)[:block.labels.shape[0]].float().numpy()
    server = InferenceModel(cfg, runs["ckpt"], device="cpu")
    got = server(block.coords, block.feats)
    assert got.shape == (8, 2) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# -- the (1, 2) grid ---------------------------------------------------------------------

def test_two_rank_dp_tp_step(runs):
    """Two ranks form a (1, 2) grid (both model ranks of one data rank) and
    step with one rank's loss and weights on the whole block."""
    one = runs["one"]["step"]
    for r, res in enumerate(runs["pair"]):
        got = res["step"]
        assert got["mesh"] == {"data": 1, "model": TP} and got["model_index"] == r
        np.testing.assert_allclose(got["step_losses"], one["losses"], rtol=RTOL, atol=ATOL)
        _assert_state(got["state"], one["state"], RTOL, ATOL)


def test_two_rank_evaluator_figures(runs):
    """``Trainer.test`` on the (1, 2) grid feeds the evaluator on the
    model-index-0 rank, and rank 0 emits its figures."""
    res = [r["evaluator"] for r in runs["pair"]]
    assert res[0]["test"] == res[1]["test"] and np.isfinite(res[0]["test"]["test_loss"])
    assert res[0]["logger"] and len(res[0]["figures"]) > 0
    assert not res[1]["logger"] and res[1]["figures"] == []


def test_two_rank_graph_step(runs):
    """The graph classifier on the (1, 2) grid (its convs' Linear layers
    column-sharded): one rank's loss and weights."""
    one = runs["one"]["pair_graph"]
    for res in runs["pair"]:
        got = res["graph"]
        assert set(got["blocks"]) == {"gconv_0.lin.weight", "gconv_1.lin.weight"}
        np.testing.assert_allclose(got["step_losses"], one["losses"], rtol=RTOL, atol=ATOL)
        _assert_state(got["state"], one["state"], RTOL, ATOL)


# -- the CLI -----------------------------------------------------------------------------

def test_four_rank_cli(runs):
    """``main --distributed --parallel gspmd --tp 2`` on four ranks: one run
    directory and checkpoint (the one-rank keys and shapes), ``fit:`` and
    ``test:`` printed alike by every rank."""
    printed = [[ln for ln in out.splitlines() if ln.startswith(("fit: ", "test: "))]
               for out in runs["cli"]]
    assert len(printed[0]) == 2 and all(p == printed[0] for p in printed), runs["cli"]
    run_dir = runs["cli_dir"] / "model" / "SubMPSD" / "runs" / "SubMPSD" / "version_0"
    ckpts = glob.glob(str(run_dir / "*.ckpt"))
    assert len(ckpts) == 1
    from waveformml_tpu_torch.config import load_config

    cfg = load_config(str(runs["cli_dir"] / "SubMPSD.json"))
    model = retrieve_class("LitPSD")(cfg, "cpu").model
    state = torch.load(ckpts[0], weights_only=True)["state_dict"]
    assert {k: v.shape for k, v in state.items()} == {
        k: v.shape for k, v in model.state_dict().items()}
