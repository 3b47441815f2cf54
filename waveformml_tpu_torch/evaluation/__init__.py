"""Evaluators of the test pass (the port's copy of waveformml_tpu/evaluation,
numpy and scipy on the host; figures through ``utils.plot``, which imports
matplotlib only when it draws).

``Trainer.test`` builds the task's evaluator (``make_evaluator``) and hands
it each test batch (``add_batch(block, db, test_out)``: the host arrays of
``prepare_block`` and the outputs copied off the device); the
``LoggingCallback`` renders it (``dump()``) through the run's logger.
``accumulated_arrays`` lists what an evaluator has accumulated, to compare
two evaluators' states.
"""
import numpy as np

from waveformml_tpu_torch.evaluation.ad1 import AD1Evaluator, SingleEndedEvaluator
from waveformml_tpu_torch.evaluation.calibrator import Calibrator
from waveformml_tpu_torch.evaluation.energy_eval import (
    EnergyEvaluatorBase, EnergyEvaluatorPhys, EnergyEvaluatorWF)
from waveformml_tpu_torch.evaluation.ez_eval import (
    EZEvaluatorBase, EZEvaluatorPhys, EZEvaluatorWF)
from waveformml_tpu_torch.evaluation.metric_agg import (
    Metric2DAggregator, MetricAggregator, MetricPairAggregator)
from waveformml_tpu_torch.evaluation.pid_eval import (
    PID_MAP, PID_MAPPED_NAMES, PIDEvaluator, map_pid, retrieve_class_names_PIDS)
from waveformml_tpu_torch.evaluation.psd_eval import PhysEvaluator, PSDEvaluator
from waveformml_tpu_torch.evaluation.roc import ROCCurve
from waveformml_tpu_torch.evaluation.seg_eval import RealDataEvaluator, SegEvaluator
from waveformml_tpu_torch.evaluation.stats import (
    ErrorAggregator, StatsAggregator, calc_photon_moments, calc_time_moments)
from waveformml_tpu_torch.evaluation.tensor_eval import TensorEvaluator
from waveformml_tpu_torch.evaluation.waveform_eval import WaveformEvaluator
from waveformml_tpu_torch.evaluation.z_eval import (
    ZEvaluatorBase, ZEvaluatorPhys, ZEvaluatorRealWFNorm, ZEvaluatorWF)


def accumulated_arrays(evaluator, prefix: str = "") -> dict:
    """Every numpy array an evaluator holds, by attribute path: its own,
    its aggregators' and sub-evaluators' (objects of this package or of the
    JAX package's evaluation, recursively), those in dicts, lists and
    tuples; a list of arrays (a sample reservoir) as one flat array. The
    logger and the calibration database are left out."""
    out, seen = {}, set()

    def walk(obj, prefix):
        if id(obj) in seen:
            return
        seen.add(id(obj))
        items = (obj.items() if isinstance(obj, dict) else
                 enumerate(obj) if isinstance(obj, (list, tuple)) else
                 ((k, v) for k, v in vars(obj).items() if k not in ("logger", "calibdb", "log")))
        for k, v in items:
            path = f"{prefix}.{k}"
            if isinstance(v, np.ndarray):
                out[path] = v
            elif isinstance(v, list) and v and all(isinstance(x, np.ndarray) for x in v):
                out[path] = np.concatenate([np.ravel(x) for x in v])
            elif isinstance(v, (dict, list, tuple)) or (
                    hasattr(v, "__dict__") and type(v).__module__.startswith("waveformml_tpu")):
                walk(v, path)

    walk(evaluator, prefix)
    return out

__all__ = [
    "AD1Evaluator", "SingleEndedEvaluator", "Calibrator",
    "EnergyEvaluatorBase", "EnergyEvaluatorPhys", "EnergyEvaluatorWF",
    "EZEvaluatorBase", "EZEvaluatorPhys", "EZEvaluatorWF",
    "Metric2DAggregator", "MetricAggregator", "MetricPairAggregator",
    "PID_MAP", "PID_MAPPED_NAMES", "PIDEvaluator", "map_pid",
    "retrieve_class_names_PIDS", "PhysEvaluator", "PSDEvaluator", "ROCCurve",
    "RealDataEvaluator", "SegEvaluator", "ErrorAggregator", "StatsAggregator",
    "calc_photon_moments", "calc_time_moments", "TensorEvaluator", "WaveformEvaluator",
    "ZEvaluatorBase", "ZEvaluatorPhys", "ZEvaluatorRealWFNorm", "ZEvaluatorWF",
    "accumulated_arrays",
]
