"""The comparison that decides ``correct`` fails where it should: the
reference in TF32 in the program's place, and runs with the timed path
broken underneath (a step that leaves the state unchanged, half of the
batch left out of the loss, an answer altered where it is produced). The
harness's look for a card is skipped; every other step of a run runs, at a
small size on the CPU. One chip, so no exchange between chips to leave out.
"""
import os

import pytest
import torch

from conftest import ROOT, SMALL, adhoc_run, small_run
from portbench import control, harness


@pytest.mark.parametrize("cell", ["scnet3d.train", "zcnn.serve", "zcnn.train"])
def test_the_tf32_control_fails_a_limit(cell):
    run = small_run(cell)
    numbers = control.reference_numbers(run, "control")
    assert any(numbers[k] > v for k, v in run.limits.items()), numbers


@pytest.mark.parametrize("cell,number", [("scnet3d.train", "change3_median_gap"),
                                         ("zcnn.train", "change3_worst_gap")])
def test_a_step_that_leaves_the_state_unchanged_is_not_correct(cell, number, monkeypatch):
    step = torch.optim.SGD.step

    def unchanged(self, closure=None):
        kept = [p.detach().clone() for g in self.param_groups for p in g["params"]]
        out = step(self, closure)
        with torch.no_grad():
            for p, k in zip([p for g in self.param_groups for p in g["params"]], kept):
                p.copy_(k)
        return out

    monkeypatch.setattr(torch.optim.SGD, "step", unchanged)
    result = harness.run_cell(small_run(cell))
    assert not result["correct"]
    assert result["checks"][number]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("config,task", [("SCNet3D", "LitPSD"), ("SingleEndedZCNN", "LitZ")])
def test_half_of_the_batch_left_out_is_not_correct(config, task, monkeypatch):
    cell = {"SCNet3D": "scnet3d.train", "SingleEndedZCNN": "zcnn.train"}[config]
    from waveformml_tpu_torch.engineering import tasks

    cls = getattr(tasks, task)
    loss = cls.loss_and_metrics

    def half(self, outputs, db):
        db = dict(db)
        n = SMALL["events"] // 2
        if cls is tasks.LitPSD:
            keep = torch.arange(db["label_mask"].shape[0]) < n
            db["label_mask"] = db["label_mask"] & keep
        else:
            db["mask"] = db["mask"] & (db["coords"][:, -1] < n)
        return loss(self, outputs, db)

    monkeypatch.setattr(cls, "loss_and_metrics", half)
    result = harness.run_cell(small_run(cell))
    assert not result["correct"], result["checks"]


def test_an_altered_answer_is_not_correct(monkeypatch):
    from waveformml_tpu_torch.inference.model import InferenceModel

    forward = InferenceModel._forward

    def altered(self, db):
        out = forward(self, db).clone()
        flat = out.view(-1)
        i = int(flat.abs().argmax())
        flat[i] = flat[i] * 1.001
        return out

    monkeypatch.setattr(InferenceModel, "_forward", altered)
    result = harness.run_cell(small_run("zcnn.serve"))
    assert not result["correct"]


def test_readings_come_for_every_kind():
    got = list(control.readings("scnet3d.train", [3], ["program", "control", "half_batch"],
                                "cpu", 0.1, SMALL))
    assert [k for _, k, _ in got] == ["program", "control", "half_batch"]
    assert got[2][2]["loss1_gap"] > got[0][2]["loss1_gap"]
