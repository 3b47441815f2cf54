"""Data-parallel training of the port on the CPU: ranks are processes
(``tests/_torch_dist_worker.py``) joined by ``torch.distributed`` over Gloo
with a ``file://`` rendezvous in the test's directory, one thread each;
every spawn has its own timeout, after which every rank is killed.

The counterpart of tests/test_distributed.py's six tests (the loader's
padding is held in tests/test_torch_parallel.py). Two ranks train 3 steps
on ``split_block_for_devices(B, 2)[r]`` (the Trainer reads the list of
shards round-robin) and one rank on B, from the same flax weights
(``convert.py``), for: ``_dist_train_common.make_cfg_block``'s SubMPSDNet;
``make_graph_cfg_block``'s graph classifier (sparse and dense events, so
the ranks' edge caps differ) with live and with cached edges; a block of
one event (the second rank's shard is empty); and an SCNet whose dense
section has flax's BatchNorm (ranks' means averaged, so shards of equal
shape: 32 events). Per-step losses, parameters and running statistics of
the two ranks equal the one rank's within rtol 1e-5, atol 1e-6, and the
JAX package's ``Trainer`` on a 2-device CPU mesh (its ``shard_map`` step,
in this process, whose JAX has 8 virtual devices) within the trajectory
tolerance rtol 2e-3, atol 2e-4. Then ``fit`` + ``test`` on two ranks (odd
loaders, padded by wrapping): equal metrics on both, one checkpoint, which
a one-rank ``Trainer`` and ``InferenceModel`` load; the two-process CLI on
synthetic HDF5 directories (one run directory, one ``run_info.json``, one
checkpoint); ``parallel="gspmd"`` and ``tp=2`` on the two ranks (the
tensor-parallel engine itself is held in tests/test_torch_gspmd.py),
``tp=2`` without a grid and ``parallel="pmap"`` refused; and
``steps_per_dispatch = 2`` equal to 1."""
import copy
import glob
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
from waveformml_tpu_torch.datasets.synthetic import BlockDataModule, labelled_block
from waveformml_tpu_torch.engineering.trainer import Trainer
from waveformml_tpu_torch.inference.model import InferenceModel
from waveformml_tpu_torch.parallel.mesh import split_block_for_devices
from waveformml_tpu_torch.registry import retrieve_class

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)
sys.path.insert(0, TESTS)
from _dist_train_common import make_cfg_block, make_graph_cfg_block  # noqa: E402

RANKS = 2
STEPS = 3
RTOL, ATOL = 1e-5, 1e-6
JAX_RTOL, JAX_ATOL = 2e-3, 2e-4
#: seconds a spawn of ranks may take before every rank is killed
TIMEOUT = 300

#: SCNet with flax's BatchNorm in its dense section (after ToDense)
DSL = ["spconv.SubMConv2d", [16, 4, 3, 1, 1, 1], "nn.BatchNorm1d", [4], "nn.ReLU",
       "spconv.ToDense", "nn.Linear", [616, 8], "nn.BatchNorm1d", [8], "nn.ReLU",
       "nn.Linear", [8, 2]]


def _config_dict(jax_cfg) -> dict:
    from waveformml_tpu.config import to_dict

    return copy.deepcopy(to_dict(jax_cfg))


def _port_block(b) -> FileBlock:
    return FileBlock(b.coords, b.feats, b.labels, dict(b.extras))


def _dsl_case():
    """make_cfg_block's config with the DSL net over 32 events of 2 rows."""
    jcfg, _ = make_cfg_block()
    d = _config_dict(jcfg)
    d["net_config"].update(net_class="SCNet", algorithm=copy.deepcopy(DSL))
    d["net_config"].pop("hparams")
    rng = np.random.default_rng(5)
    coords = np.asarray([[s % 14, s // 14, e] for e in range(32)
                         for s in rng.choice(154, size=2, replace=False)], np.int32)
    feats = rng.normal(size=(coords.shape[0], 16)).astype(np.float32)
    return d, FileBlock(coords, feats, rng.integers(0, 2, 32).astype(np.int64), {})


def _cases() -> dict:
    """name -> (config dict, block)."""
    jcfg, block = make_cfg_block()
    d = _config_dict(jcfg)
    one = block.coords[:, -1] == 0
    cases = {"SubMPSDNet": (d, _port_block(block)),
             "one_event": (d, FileBlock(block.coords[one], block.feats[one], block.labels[:1]))}
    for name, cached in (("graph", False), ("graph_cached_edges", True)):
        gcfg, gblock = make_graph_cfg_block(cached_edges=cached)
        cases[name] = (_config_dict(gcfg), _port_block(gblock))
    cases["dsl_flax_batchnorm"] = _dsl_case()
    return cases


def _flat_state(trainer) -> dict:
    from flax.traverse_util import flatten_dict
    import jax

    tree = {"params": trainer.state.params}
    if trainer.state.batch_stats is not None:
        tree["batch_stats"] = trainer.state.batch_stats
    flat = flatten_dict(jax.device_get(tree), sep="/")
    return {k: v.numpy() for k, v in flax_to_state_dict(
        {k: np.asarray(v) for k, v in flat.items()}).items()}


def _jax_trajectory(d: dict, block: FileBlock):
    """The JAX Trainer on a 2-device mesh, STEPS steps on ``block`` (split
    over the devices by its ``_device_batch``): the initial weights as a
    port state dict, the step losses, the final state."""
    import jax
    import jax.numpy as jnp

    from waveformml_tpu.config import Config as JaxConfig
    from waveformml_tpu.datasets.hdf5_dataset import FileBlock as JaxFileBlock
    from waveformml_tpu.engineering.trainer import Trainer as JaxTrainer
    from waveformml_tpu.parallel.mesh import make_mesh
    from waveformml_tpu.registry import retrieve_class as jax_class

    jcfg = JaxConfig(copy.deepcopy(d))
    jt = JaxTrainer(jcfg, jax_class(jcfg.run_config.run_class)(jcfg),
                    mesh=make_mesh(jax.devices()[:RANKS]), seed=0)
    jb = JaxFileBlock(block.coords, block.feats, block.labels, dict(block.extras))
    jt._ensure_state(jb)
    init = _flat_state(jt)
    losses = []
    for i in range(STEPS):
        db = {k: jnp.asarray(v) for k, v in jt._device_batch(jb).items()}
        st = jt.state
        st.params, st.batch_stats, st.opt_state, loss, _ = jt._train_step_fn(
            st.params, st.batch_stats, st.opt_state, jax.random.PRNGKey(i), db)
        losses.append(float(loss))
    return init, losses, _flat_state(jt)


def _one_rank(d: dict, init: dict, train, val, **kwargs):
    cfg = Config(copy.deepcopy(d))
    task = retrieve_class(cfg.run_config.run_class)(cfg, "cpu")
    task.model.load_state_dict({k: torch.as_tensor(v) for k, v in init.items()})
    trainer = Trainer(cfg, task, device="cpu", **kwargs)
    fit = trainer.fit(BlockDataModule(train, val))
    return trainer, fit, {k: v.numpy() for k, v in task.model.state_dict().items()}


def spawn(args_of_rank, tmp_path, env_extra=None, timeout=TIMEOUT):
    """Start one process per rank (``args_of_rank(r)``: its argv after the
    interpreter), wait for each at most ``timeout`` seconds,
    killing every one on a timeout; assert each exited 0. Returns the
    outputs."""
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1", **(env_extra or {})}
    procs = [subprocess.Popen([sys.executable, *args_of_rank(r)], cwd=str(tmp_path), env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(RANKS)]
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


def _fit_test_case(tmp_path):
    """make_cfg_block's config for 2 epochs over 5 training blocks, 2
    validation and 3 test blocks of 8 events."""
    jcfg, _ = make_cfg_block()
    d = _config_dict(jcfg)
    d["optimize_config"]["total_epoch"] = 2
    rng = np.random.default_rng(17)
    blocks = [labelled_block(rng, 8, 8) for _ in range(10)]
    cfg = Config(copy.deepcopy(d))
    torch.manual_seed(0)
    init = {k: v.numpy() for k, v in
            retrieve_class("LitPSD")(cfg, "cpu").model.state_dict().items()}
    return {"config": d, "init": init, "train": blocks[:5], "val": blocks[5:7],
            "test": blocks[7:], "trainer": {"checkpoint_dir": str(tmp_path / "ckpt"),
                                            "early_stopping_patience": 10}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case through the JAX Trainer, one rank and two ranks (one
    spawn of two ranks for all of them and the fit + test case)."""
    tmp = tmp_path_factory.mktemp("dp")
    out, job_cases = {}, {}
    cases = _cases()
    for name, (d, block) in cases.items():
        init, jax_losses, jax_state = _jax_trajectory(d, block)
        trainer, fit, state = _one_rank(d, init, [block] * STEPS, [block])
        out[name] = {"jax_losses": jax_losses, "jax_state": jax_state,
                     "losses": list(trainer.step_losses), "fit": fit, "state": state}
        shards = split_block_for_devices(block, RANKS)
        job_cases[name] = {"config": d, "init": init, "train": shards * STEPS, "val": shards}
    job_cases["fit_test"] = _fit_test_case(tmp)
    for name, kwargs in ENGINE_CASES.items():
        case = dict(job_cases["SubMPSDNet"], trainer=kwargs)
        if kwargs.get("tp") == 2:
            # a (1, 2) grid: both ranks read the whole block
            block = cases["SubMPSDNet"][1]
            case.update(train=[block] * STEPS, val=[block])
        job_cases[name] = case
    job = str(tmp / "job")
    with open(job, "wb") as f:
        pickle.dump({"init_method": f"file://{tmp}/rendezvous", "cases": job_cases}, f)
    spawn(lambda r: [os.path.join(TESTS, "_torch_dist_worker.py"), job, str(r), str(RANKS)],
          tmp)
    ranks = []
    for r in range(RANKS):
        with open(f"{job}.rank{r}", "rb") as f:
            ranks.append(pickle.load(f))
    return {"one": out, "ranks": ranks, "fit_test": job_cases["fit_test"], "tmp": tmp}


CASES = ["SubMPSDNet", "one_event", "graph", "graph_cached_edges", "dsl_flax_batchnorm"]
#: the SubMPSDNet case again under the GSPMD engine's flags
ENGINE_CASES = {"gspmd": {"parallel": "gspmd"}, "tp": {"tp": 2},
                "gspmd_tp": {"parallel": "gspmd", "tp": 2}}


def test_cases_hold_what_they_claim():
    """The one-event block leaves the second rank an empty shard; the graph
    blocks' shards differ in edge counts; the DSL net has flax's BatchNorm
    in its dense section and the masked one in its sparse section."""
    from waveformml_tpu_torch.models.blocks import MaskedArrayBatchNorm
    from waveformml_tpu_torch.nn.layers import _FlaxBatchNorm

    cases = _cases()
    shards = split_block_for_devices(cases["one_event"][1], RANKS)
    assert [s.coords.shape[0] for s in shards][1] == 0 and shards[1].labels.shape == (0,)
    d, block = cases["graph"]
    sizes = [s.coords.shape[0] for s in split_block_for_devices(block, RANKS)]
    assert sizes[0] < sizes[1], sizes
    cfg = Config(copy.deepcopy(cases["dsl_flax_batchnorm"][0]))
    kinds = {type(m) for m in retrieve_class("LitPSD")(cfg, "cpu").model.modules()}
    assert {_FlaxBatchNorm, MaskedArrayBatchNorm} <= kinds


@pytest.mark.parametrize("name", CASES)
def test_two_ranks_match_one_rank(runs, name):
    """Both ranks step with the losses, and end with the parameters and
    running statistics, of one rank over the whole blocks; the validation
    loss too."""
    one = runs["one"][name]
    for rank in runs["ranks"]:
        got = rank[name]
        assert got["world_size"] == RANKS
        np.testing.assert_allclose(got["step_losses"], one["losses"], rtol=RTOL, atol=ATOL)
        assert sorted(got["state"]) == sorted(one["state"])
        for k, v in one["state"].items():
            np.testing.assert_allclose(got["state"][k], v, rtol=RTOL, atol=ATOL, err_msg=k)
        for k, v in one["fit"].items():
            assert got["fit"][k] == pytest.approx(v, rel=RTOL, abs=ATOL), k


@pytest.mark.parametrize("name", CASES)
def test_two_ranks_match_jax_shard_map(runs, name):
    """The JAX Trainer's shard_map step on two devices: the same losses,
    parameters and running statistics after 3 steps."""
    one = runs["one"][name]
    for rank in runs["ranks"]:
        got = rank[name]
        np.testing.assert_allclose(got["step_losses"], one["jax_losses"], rtol=JAX_RTOL,
                                   atol=JAX_ATOL)
        assert sorted(got["state"]) == sorted(one["jax_state"])
        for k, v in one["jax_state"].items():
            np.testing.assert_allclose(got["state"][k], v, rtol=JAX_RTOL, atol=JAX_ATOL,
                                       err_msg=k)


def test_fit_and_test_end_to_end(runs):
    """Two ranks fit 2 epochs over 5 training blocks (3 steps a rank, one
    block replayed) and test 3 blocks (2 a rank): the same metrics on both,
    one checkpoint written (by rank 0), which a one-rank Trainer and
    InferenceModel load and score with the recorded validation loss."""
    case = runs["fit_test"]
    a, b = (rank["fit_test"] for rank in runs["ranks"])
    assert a["fit"] == b["fit"] and a["test"] == b["test"]
    assert len(a["step_losses"]) == 2 * 3 and a["step_losses"] == b["step_losses"]
    assert [len(r["collected"]) for r in (a, b)] == [2, 2]
    # dropout: rank 0 draws the seed's stream, rank 1 another; a logger on
    # rank 0 only
    assert a["seed"] == 0 and b["seed"] != 0
    assert (a["logger"], b["logger"]) == (True, False)
    for n_labels, n_out in a["collected"] + b["collected"]:
        assert n_labels == n_out == 8
    ckpts = glob.glob(os.path.join(case["trainer"]["checkpoint_dir"], "*.ckpt"))
    assert ckpts == [a["best_ckpt_path"]] == [b["best_ckpt_path"]]
    ckpt = torch.load(ckpts[0], weights_only=True)
    cfg = Config(copy.deepcopy(case["config"]))
    trainer = Trainer(cfg, retrieve_class("LitPSD")(cfg, "cpu"), device="cpu")
    trainer.load_checkpoint(ckpts[0])
    val = trainer.validate(BlockDataModule([], case["val"]))
    assert val["val_loss"] == pytest.approx(ckpt["best_val_loss"], rel=RTOL)
    server = InferenceModel(cfg, ckpts[0], device="cpu")
    loss_sum, count = 0.0, 0
    for block in case["val"]:
        logits = torch.from_numpy(server(block.coords, block.feats))
        loss_sum += float(torch.nn.functional.cross_entropy(
            logits, torch.from_numpy(block.labels), reduction="sum"))
        count += block.labels.shape[0]
    assert loss_sum / count == pytest.approx(ckpt["best_val_loss"], rel=RTOL)


def test_two_process_cli(tmp_path):
    """``python -m waveformml_tpu_torch.main <cfg> -t --distributed`` in two
    processes: one run directory (``version_0``) with one ``run_info.json``
    and one checkpoint, ``fit:`` and ``test:`` printed by both ranks with
    the same values."""
    import json

    from waveformml_tpu_torch.datasets.synthetic import write_classification_dirs

    write_classification_dirs(str(tmp_path / "data"), ["Ioni", "Recoil"], n_files=4,
                              events_per_file=20, n_samples=8, seed=5)
    with open(os.path.join(ROOT, "config", "examples", "SubMPSD.json")) as f:
        cfg = json.load(f)
    cfg["system_config"].update(n_samples=8, model_base_path=str(tmp_path / "model"))
    # every rank would write the offline shuffle's files: none here
    cfg["dataset_config"].pop("data_prep")
    cfg["dataset_config"].update(base_path=str(tmp_path / "data"), n_train=40,
                                 n_validate=20, n_test=20,
                                 dataloader_params={"batch_size": 1, "num_workers": 0})
    path = str(tmp_path / "SubMPSD.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    outs = spawn(lambda r: ["-m", "waveformml_tpu_torch.main", path, "-t", "--max_epochs", "2",
                            "-v", "2", "--device", "cpu", "--distributed", "--coordinator",
                            f"file://{tmp_path}/rendezvous", "--num_processes", str(RANKS),
                            "--process_id", str(r)], tmp_path)
    printed = [[ln for ln in out.splitlines() if ln.startswith(("fit: ", "test: "))]
               for out in outs]
    assert len(printed[0]) == 2 and printed[0] == printed[1], outs
    runs_dir = tmp_path / "model" / "SubMPSD" / "runs"
    assert sorted(os.listdir(runs_dir)) == ["SubMPSD"]
    assert sorted(os.listdir(runs_dir / "SubMPSD")) == ["version_0"]
    run_dir = runs_dir / "SubMPSD" / "version_0"
    assert glob.glob(str(tmp_path / "model" / "**" / "run_info.json"), recursive=True) == [
        str(run_dir / "run_info.json")]
    assert len(glob.glob(str(run_dir / "*.ckpt"))) == 1
    assert len(glob.glob(str(run_dir / "*tfevents*"))) == 1


@pytest.mark.parametrize("name", ENGINE_CASES)
def test_gspmd_engine_constructs_on_two_ranks(runs, name):
    """``parallel="gspmd"`` and ``tp=2`` construct under a 2-rank group: with
    ``tp = 1`` the data-parallel engine (its results those of the default
    engine), with ``tp = 2`` a (1, 2) grid whose steps are one rank's."""
    kwargs = ENGINE_CASES[name]
    one = runs["one"]["SubMPSDNet"]
    for r, rank in enumerate(runs["ranks"]):
        got = rank[name]
        tp = kwargs.get("tp", 1)
        assert got["mesh"] == ({"data": 1, "model": 2} if tp == 2 else None)
        assert (got["data_index"], got["model_index"]) == ((0, r) if tp == 2 else (r, 0))
        if tp == 1:
            assert got["step_losses"] == rank["SubMPSDNet"]["step_losses"]
        np.testing.assert_allclose(got["step_losses"], one["losses"], rtol=RTOL, atol=ATOL)
        for k, v in one["state"].items():
            np.testing.assert_allclose(got["state"][k], v, rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("world", [None, 3], ids=["no_group", "world_of_3"])
def test_tp_refused_without_a_grid(world, monkeypatch):
    """``tp=2`` with no process group, or over a world of 3 ranks, raises
    ValueError: the ranks cannot form the grid."""
    jcfg, _ = make_cfg_block()
    cfg = Config(_config_dict(jcfg))
    if world is None:
        with pytest.raises(ValueError, match="cannot form a"):
            Trainer(cfg, retrieve_class("LitPSD")(cfg, "cpu"), device="cpu", tp=2)
        return
    with pytest.raises(ValueError, match="3 devices cannot form a"):
        Trainer.check_engine("gspmd", 2, world)
    import torch.distributed as dist

    from waveformml_tpu_torch.parallel.gspmd import make_mesh_2d

    monkeypatch.setattr(dist, "get_world_size", lambda *a, **k: world)
    with pytest.raises(ValueError, match=r"3 devices cannot form a \(1, 2\) mesh"):
        make_mesh_2d(tp=2)


def test_pmap_engine_raises():
    jcfg, _ = make_cfg_block()
    cfg = Config(_config_dict(jcfg))
    with pytest.raises(ValueError, match="shard_map"):
        Trainer(cfg, retrieve_class("LitPSD")(cfg, "cpu"), device="cpu", parallel="pmap")


def test_steps_per_dispatch_equals_one():
    """K = 2 (the JAX CLI's flag, accepted; every K steps one batch at a
    time) over 6 blocks whose third changes the row bucket: the losses,
    metrics, weights and step records of K = 1."""
    jcfg, _ = make_cfg_block()
    d = _config_dict(jcfg)
    rng = np.random.default_rng(9)
    blocks = [labelled_block(rng, n, 8) for n in (8, 8, 300, 8, 8, 8)]
    torch.manual_seed(0)
    cfg = Config(copy.deepcopy(d))
    init = {k: v.numpy() for k, v in
            retrieve_class("LitPSD")(cfg, "cpu").model.state_dict().items()}
    one = _one_rank(d, init, blocks, blocks[:1], max_epochs=2)
    two = _one_rank(d, init, blocks, blocks[:1], max_epochs=2, steps_per_dispatch=2)
    assert two[0].step_losses == one[0].step_losses
    assert two[1] == one[1]
    for k, v in one[2].items():
        np.testing.assert_array_equal(two[2][k], v, err_msg=k)
    assert len(two[0].step_phases) == 12
