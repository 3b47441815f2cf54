"""Shared inputs of the evaluator tests of the port against the JAX
package (tests/test_torch_evaluation.py, tests/test_torch_evaluation_z.py):
a recording logger, seeded padded test batches for each evaluator case,
and the comparison of two evaluators fed the same outputs."""
import importlib

import numpy as np
import pytest

NX, NY = 14, 11
N_SAMPLES = 40
RTOL = 1e-12


class FakeLogger:
    """Records what an evaluator logs; closes each figure."""

    def __init__(self):
        self.figures = set()
        self.histograms = set()
        self.scalars = {}

    def log_figure(self, tag, fig, step=0, close=True):
        import matplotlib.pyplot as plt

        self.figures.add(tag)
        plt.close(fig)

    def log_histogram(self, tag, values, step=0):
        self.histograms.add(tag)

    def log_scalar(self, tag, value, step=0):
        self.scalars[tag] = float(value)

    def log_scalars(self, values, step=0):
        for k, v in values.items():
            self.log_scalar(k, v, step)

    def flush(self):
        pass


def _padded(x, n, fill=0):
    out = np.full((n,) + x.shape[1:], fill, dtype=x.dtype)
    out[:x.shape[0]] = x
    return out


def _batch(case, seed):
    """(db, test_out, n_out) of one padded test batch for an evaluator
    case: the host arrays as ``prepare_block`` lays them out and the
    outputs over the padded events or rows; ``n_out`` is the number of
    real events or rows the port's Trainer hands over."""
    from waveformml_tpu_torch.datasets.synthetic import make_events
    from waveformml_tpu_torch.evaluation.pid_eval import PID_MAP
    from waveformml_tpu_torch.ops.sparse import consecutive_event_index

    rng = np.random.default_rng(seed)
    n_ev = 24
    ev = make_events(rng, n_ev, N_SAMPLES)
    coords = ev["coords"]
    n = coords.shape[0]
    rows, events = n + 13, 32
    phys = np.stack([ev["E"] / 12.0, rng.uniform(0, 1, n), rng.uniform(0, 1, n),
                     rng.uniform(0, 1, n), ev["z"] / 1200.0 + 0.5,
                     rng.uniform(0.05, 0.5, n), rng.uniform(0, 1, n)], 1)
    phys[rng.random(n) < 0.3, 4] = 0.5
    wf = ev["waveforms"] / 16383.0
    db = {"coords": _padded(coords, rows), "mask": _padded(np.ones(n, bool), rows),
          "label_mask": _padded(np.ones(n_ev, bool), events)}
    if case in ("psd", "psd_cal", "phys"):
        db["feats"] = _padded(phys if case == "phys" else wf, rows)
        db["labels"] = _padded(rng.integers(0, 2, n_ev), events)
        logits = rng.normal(size=(events, 2))
        return db, {"logits": logits, "pred": logits.argmax(1),
                    "logprob": logits - np.log(np.exp(logits).sum(1, keepdims=True))}, n_ev
    if case in ("pid", "pid_all", "seg"):
        db["feats"] = _padded(wf, rows)
        db["extra_phys"] = _padded(phys, rows)
        if case == "seg":
            db["labels_rows"] = _padded(phys[:, :2].astype(np.float32), rows)
            db["extra_PID"] = _padded(rng.choice(list(PID_MAP), n), rows)
            return db, {"predictions": rng.uniform(0, 1, (rows, 1))}, n
        db["labels_rows"] = _padded(rng.integers(0, 5, n), rows)
        logits = rng.normal(size=(rows, 5))
        return db, {"logits": logits, "pred": logits.argmax(1)}, n
    # the per-segment regressors: dense [B, C, NX, NY] maps over the events
    c = 2 if case.startswith("ez") else 1
    b = consecutive_event_index(coords[:, 2])
    target = np.zeros((events, c, NX, NY))
    tv = np.stack([ev["E"] / 12.0, ev["z"] / 1200.0 + 0.5], 1)[:, 2 - c:]
    target[b, :, coords[:, 0], coords[:, 1]] = tv
    pred = np.zeros_like(target)
    pred[b, :, coords[:, 0], coords[:, 1]] = np.clip(tv + rng.normal(0, 0.05, tv.shape), 0, 1)
    db["feats"] = _padded(phys if case.endswith("phys") else wf, rows)
    return db, {"predictions": pred, "target": target}, n_ev


#: case → (evaluator class name, its module, constructor arguments, calgroup?)
EVALUATORS = {
    "psd": ("PSDEvaluator", "psd_eval", dict(class_names=["a", "b"]), False),
    "psd_cal": ("PSDEvaluator", "psd_eval", dict(class_names=["a", "b"]), True),
    "phys": ("PhysEvaluator", "psd_eval", dict(class_names=["a", "b"]), False),
    "pid": ("PIDEvaluator", "pid_eval", dict(SE_only=True), False),
    "pid_all": ("PIDEvaluator", "pid_eval", dict(SE_only=False), False),
    "seg": ("SegEvaluator", "seg_eval", dict(target_index=1), False),
    "z_wf": ("ZEvaluatorWF", "z_eval", {}, True),
    "z_phys": ("ZEvaluatorPhys", "z_eval", {}, True),
    "z_real": ("ZEvaluatorRealWFNorm", "z_eval", {}, True),
    "ez_wf": ("EZEvaluatorWF", "ez_eval", dict(e_scale=12.0), True),
    "ez_phys": ("EZEvaluatorPhys", "ez_eval", dict(e_scale=12.0), True),
}


@pytest.fixture
def caldb(tmp_path, monkeypatch):
    """A synthetic calibration database's group, the database in
    ``PROSPECT_CALDB``."""
    from waveformml_tpu_torch.io.sql import write_synthetic_caldb

    path = str(tmp_path / "cal.db")
    write_synthetic_caldb(path, "evalcal", seed=6)
    monkeypatch.setenv("PROSPECT_CALDB", path)
    return "evalcal"


def assert_evaluators_match(case, calgroup):
    """The JAX and the port's evaluator of ``case`` fed two seeded batches
    (the JAX one with a leading device axis of 1, the port's the outputs
    over the real events or rows only) hold equal accumulated arrays and,
    after ``dump()``, have logged the same figure, histogram and scalar
    tags, with equal scalars."""
    from waveformml_tpu_torch.evaluation import accumulated_arrays

    name, module, kwargs, cal = EVALUATORS[case]
    kwargs = dict(kwargs, calgroup=calgroup if cal else None)
    jax_ev = getattr(importlib.import_module(f"waveformml_tpu.evaluation.{module}"), name)(
        **kwargs)
    port_ev = getattr(importlib.import_module(f"waveformml_tpu_torch.evaluation.{module}"),
                      name)(**kwargs)
    for seed in (1, 2):
        db, test_out, n = _batch(case, seed)
        jax_ev.add_batch(None, {k: v[None] for k, v in db.items()},
                         {k: v[None] for k, v in test_out.items()})
        port_ev.add_batch(None, db, {k: v[:n] for k, v in test_out.items()})
    want, got = accumulated_arrays(jax_ev), accumulated_arrays(port_ev)
    assert sorted(got) == sorted(want)
    assert any(np.any(v) for v in want.values())
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=0, err_msg=k)

    jax_log, port_log = FakeLogger(), FakeLogger()
    for ev, lg in ((jax_ev, jax_log), (port_ev, port_log)):
        if hasattr(ev, "set_logger"):
            ev.set_logger(lg)
        else:
            ev.logger = lg
        ev.dump()
    assert jax_log.figures and port_log.figures == jax_log.figures
    assert port_log.histograms == jax_log.histograms
    assert sorted(port_log.scalars) == sorted(jax_log.scalars)
    for k, v in jax_log.scalars.items():
        np.testing.assert_allclose(port_log.scalars[k], v, rtol=RTOL, err_msg=k)
