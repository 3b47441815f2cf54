"""Each configuration's plain reference against the port run on the CPU at
a small size (the reference itself imports nothing of the port)."""
import numpy as np
import torch

from conftest import adhoc_run, small_run
from portbench import compare, harness
from portbench.harness import load_module


def test_zcnn_served_map_matches_the_port():
    from waveformml_tpu_torch.inference.model import InferenceModel

    run = small_run("zcnn.serve")
    weights = run.weights()
    model = InferenceModel(run.program_config, weights, device="cpu")
    ref = load_module("reference", "SingleEndedZCNN")
    for c in run.pool:
        want = ref.serve(run.config["config"], weights, c)
        got = model(c.coords, c.feats)
        assert (want > 0).mean() > 0.05          # the map depends on the data
        assert compare.serve_error([got], [want]) < 1e-5


def test_scnet3d_logits_match_the_port_in_evaluation():
    from waveformml_tpu_torch.datasets.hdf5_dataset import FileBlock
    from waveformml_tpu_torch.registry import retrieve_class

    run = small_run("scnet3d.train")
    cfg = run.program_config
    task = retrieve_class(cfg.run_config.run_class)(cfg, "cpu")
    weights = run.weights()
    task.model.load_state_dict(weights)
    ref = load_module("reference", "SCNet3D")
    for c in run.pool:
        block = FileBlock(coords=c.coords, feats=c.feats, labels=c.labels)
        db = task.to_device(task.prepare_block(block, task.row_bucket(block),
                                               task.event_bucket(block)))
        got = task.apply_model(db)[:c.n_events]
        want = ref.forward(weights, torch.as_tensor(c.coords), torch.as_tensor(c.feats),
                           c.n_events, 16, train=False)
        assert float(want.std()) > 0.1           # logits of the calibrated head
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_training_steps_match_the_port():
    limits = {"loss1_gap": 1e-6, "grad1_median_gap": 1e-5, "change3_median_gap": 1e-5}
    for run in (small_run("scnet3d.train"), adhoc_run("SingleEndedZCNN", "train", limits)):
        result = harness.run_cell(run)
        checks = result["checks"]
        assert result["correct"], checks
        assert checks["loss1_gap"]["value"] < 1e-6
        assert checks["grad1_median_gap"]["value"] < 1e-5
        assert checks["change3_median_gap"]["value"] < 1e-5


def test_half_batch_reference_differs():
    run = adhoc_run("SingleEndedZCNN", "train", {})
    ref = load_module("reference", "SingleEndedZCNN")
    a = ref.train_steps(run.config["config"], run.weights(), run.pool[:3], [0, 1, 1])
    b = ref.train_steps(run.config["config"], run.weights(), run.pool[:3], [0, 1, 1],
                        half_batch=True)
    assert not np.isclose(a["losses"][0], b["losses"][0], rtol=1e-4)
