"""The per-segment regressors' evaluators of the port against the JAX
package's, on the CPU, with a synthetic calibration group so that the
classical (z, E) baselines run (``Calibrator``, ``CalCurve``,
``calc_calib_z_E``): ``ZEvaluatorWF``, ``ZEvaluatorPhys``,
``ZEvaluatorRealWFNorm``, ``EZEvaluatorWF`` and ``EZEvaluatorPhys``, fed
the same dense predictions, hold equal accumulated arrays and log the
same figure and scalar tags, with equal scalars."""
import pytest

from _torch_eval_common import EVALUATORS, assert_evaluators_match, caldb  # noqa: F401


@pytest.mark.parametrize("case", sorted(c for c in EVALUATORS if c.startswith(("z_", "ez_"))))
def test_evaluator_matches_jax(case, caldb):
    assert_evaluators_match(case, caldb)
