"""The port's evaluation layer against the JAX package's, on the CPU: the
numpy modules it copies (``ops.dsp``, ``utils.hist``, the bins and
``safe_divide``, ``io.sql.CalCurve``, the classical reconstruction of
``ops.calibration``) give equal outputs on the same seeded inputs; each
ported evaluator, fed the same test outputs (the JAX one with a leading
device axis of 1, the port's over the real events or rows only, as the
port's ``Trainer`` hands them over), holds equal accumulated arrays and
logs the same figure, histogram and scalar tags, with equal scalars."""
import numpy as np
import pytest

from _torch_eval_common import (EVALUATORS, N_SAMPLES, NX, NY, RTOL,  # noqa: F401
                                assert_evaluators_match, caldb)


def _assert_equal_outputs(got, want, path="out"):
    """Equal nested outputs: arrays and floats to RTOL, the rest exactly."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_equal_outputs(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_equal_outputs(g, w, f"{path}[{i}]")
    elif want is None:
        assert got is None, path
    else:
        np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                                   np.asarray(want, dtype=np.float64),
                                   rtol=RTOL, atol=0, err_msg=path)


# -- the numpy modules ------------------------------------------------------------------------

def _pulses(seed, n_events=12):
    from waveformml_tpu_torch.datasets.synthetic import make_events

    ev = make_events(np.random.default_rng(seed), n_events, N_SAMPLES)
    return ev["coords"], ev["waveforms"].astype(np.float64)


def _dsp_cases():
    """(name, function(module dsp, numpy inputs) → outputs) of ops.dsp."""
    def hist(m, r):
        out1, out2 = np.zeros(12), np.zeros((7, 6))
        v = r.normal(size=200)
        m.hist_add_1d(v, out1, (-2.0, 2.0), 10)
        m.hist_add_2d(v[:100], v[100:], out2, (-1.5, 1.5), (-2.0, 2.0), 5, 4)
        return out1, out2

    def confusion(m, r):
        p, lab = r.integers(0, 3, 80), r.integers(0, 3, 80)
        out, out_e = np.zeros((3, 3)), np.zeros((5, 3, 3))
        m.confusion_accumulate(p, lab, out)
        m.confusion_accumulate_1d(p, lab, r.uniform(-1, 11, 80), out_e, (0.0, 10.0), 4)
        return out, out_e

    def welford(m, r):
        mean, count, m2 = np.zeros(8), np.zeros(8), np.zeros(8)
        for _ in range(3):
            m.welford_accumulate_1d(r.normal(size=50), r.uniform(-1, 7, 50), mean, count,
                                    m2, (0.0, 6.0), 6)
        out, n = np.zeros((6, 5)), np.zeros((6, 5))
        m.metric_accumulate_2d(r.normal(size=60), np.stack([r.uniform(-1, 5, 60),
                                                            r.uniform(-1, 4, 60)], 1),
                               out, n, (0.0, 4.0), (0.0, 3.0), 4, 3)
        return mean, count, m2, m.finalize_welford(count, m2), out, n

    def moments(m, r):
        data, w = r.uniform(0, 1, (30, 5)), r.uniform(0, 1, (30, 5))
        return [m.moment(d, len(d), wt) for d, wt in zip(data, w)] + [m.moment(data[0], 3)]

    def arrival_psd(m, r):
        _, wfs = _pulses(int(r.integers(1 << 30)))
        half = wfs[:, :N_SAMPLES]
        arr = m.calc_arrival_batch(half)
        return (arr, [m.calc_arrival(w) for w in half],
                [m.calc_psd(w, a) for w, a in zip(half, arr)],
                [m.calc_time(w) for w in half])

    def peaks(m, r):
        _, wfs = _pulses(int(r.integers(1 << 30)))
        out = []
        for w in wfs[:, :N_SAMPLES]:
            maxloc, pk = m.find_peaks(w, 10)
            culled = m.strip_sentinel(m.cull_peaks(pk, w, maxloc))
            out.append((maxloc, pk, culled, m.find_peak(w),
                        m.calc_size(w, int(np.argmax(w))), m.average_median(w)))
        return out

    def average_pulse(m, r):
        from waveformml_tpu_torch.engineering.se_mask import seg_status_maps

        coords, wfs = _pulses(int(r.integers(1 << 30)))
        times = np.arange(2, N_SAMPLES * 4 + 2, 4, dtype=np.float64)
        gains = r.uniform(0.8, 1.2, (NX, NY, 2))
        return m.average_pulse(coords, wfs, gains, times, seg_status_maps()[0], 12)

    def weighted(m, r):
        coords, _ = _pulses(int(r.integers(1 << 30)))
        return m.weighted_average_quantities(coords, r.uniform(0, 1, (7, coords.shape[0])), 12)

    def align(m, r):
        _, wfs = _pulses(int(r.integers(1 << 30)))
        half = wfs[:, :N_SAMPLES]
        return m.align_wfs(half, m.calc_arrival_batch(half))

    return [("hist", hist), ("confusion", confusion), ("welford", welford),
            ("moments", moments), ("arrival_psd", arrival_psd), ("peaks", peaks),
            ("average_pulse", average_pulse), ("weighted", weighted), ("align", align)]


@pytest.mark.parametrize("name,fn", _dsp_cases(), ids=[c[0] for c in _dsp_cases()])
def test_dsp_matches_jax(name, fn):
    from waveformml_tpu.ops import dsp as jax_dsp

    from waveformml_tpu_torch.ops import dsp

    want = fn(jax_dsp, np.random.default_rng(7))
    got = fn(dsp, np.random.default_rng(7))
    _assert_equal_outputs(got, want)


def test_hist_bins_and_safe_divide_match_jax():
    from waveformml_tpu.utils import hist as jax_hist
    from waveformml_tpu.utils import util as jax_util

    from waveformml_tpu_torch.utils import hist, util

    def run(h, u):
        rng = np.random.default_rng(3)
        h1, h1w = h.HistCollator(10, (0.0, 5.0)), h.HistCollator(8)
        h2 = h.Hist2DCollator((6, 4), ((0.0, 5.0), (-1.0, 1.0)))
        for _ in range(3):
            v = rng.normal(2.5, 2.0, 40)
            h1.add(v)
            h1w.add(v, weights=rng.uniform(0, 1, 40))
            h2.add(v, rng.normal(0, 1, 40))
        h1.merge(h1)
        return (h1.counts, h1.normalized(), h1w.counts, h1w.edges, h2.counts, h2.edges,
                u.get_bins(-1.0, 3.0, 8), u.get_bin_midpoints(-1.0, 3.0, 8),
                u.safe_divide(rng.normal(size=6), np.array([0.0, 1.0, 2.0, 0.0, -1.0, 3.0])))

    _assert_equal_outputs(run(hist, util), run(jax_hist, jax_util))


def test_cal_curve_and_calibrator_match_jax(tmp_path):
    from waveformml_tpu.evaluation.calibrator import Calibrator as JaxCalibrator
    from waveformml_tpu.io.sql import CalCurve as JaxCalCurve
    from waveformml_tpu.io.sql import CalibrationDB as JaxCalibrationDB

    from waveformml_tpu_torch.evaluation.calibrator import Calibrator
    from waveformml_tpu_torch.io.sql import CalCurve, CalibrationDB, write_synthetic_caldb

    rng = np.random.default_rng(5)
    xs, ys = np.sort(rng.uniform(-600, 600, 15)), rng.normal(size=15)
    curves = []
    for cls in (CalCurve, JaxCalCurve):
        c = cls()
        for x, y in zip(xs[::-1], ys[::-1]):
            c.add_point(float(x), float(y), 0.0, 0.1)
        c.sort()
        curves.append(c.eval(np.linspace(-500, 500, 33)))
    _assert_equal_outputs(curves[0], curves[1])

    path = str(tmp_path / "cal.db")
    write_synthetic_caldb(path, "cal", seed=4)
    got = Calibrator(CalibrationDB(path, "cal")).tables()
    want = JaxCalibrator(JaxCalibrationDB(path, "cal")).tables()
    _assert_equal_outputs(vars(got), vars(want))


@pytest.mark.parametrize("tables", ["synthetic", "caldb"])
def test_classical_reconstruction_matches_jax(tmp_path, tables):
    """calc_calib_z_E (with the separated baselines), E_basic_prediction
    and z_basic_prediction over seeded pulses."""
    from waveformml_tpu.ops import calibration as jax_cal

    from waveformml_tpu_torch.engineering.se_mask import seg_status_maps
    from waveformml_tpu_torch.evaluation.calibrator import Calibrator
    from waveformml_tpu_torch.io.sql import CalibrationDB, write_synthetic_caldb
    from waveformml_tpu_torch.ops import calibration

    coords, wfs = _pulses(11, n_events=16)
    wfs = wfs / 16383.0
    if tables == "caldb":
        path = str(tmp_path / "cal.db")
        write_synthetic_caldb(path, "cal", seed=2)
        tab = Calibrator(CalibrationDB(path, "cal")).tables()
    else:
        tab = calibration.make_synthetic_tables()

    def run(m):
        rng = np.random.default_rng(1)
        maps = [np.zeros((16, NX, NY)) for _ in range(4)]
        m.calc_calib_z_E(coords, wfs, maps[0], maps[1], tab, 1200.0, N_SAMPLES,
                         z_dt_out=maps[2], z_light_out=maps[3])
        n = coords.shape[0]
        E, PE0, PE1 = rng.uniform(0.5, 8, n), rng.uniform(0, 900, n), rng.uniform(0, 900, n)
        PE0[::5] = 0
        z = rng.uniform(-600, 600, n)
        pred_E = np.zeros(n)
        m.E_basic_prediction(coords, E, PE0, PE1, z, seg_status_maps()[0],
                             tab.light_pos_curves, tab.light_sum_curves, pred_E)
        feat = rng.uniform(0, 1, n)
        feat[::3] = 0.5
        pred_z = np.zeros(n)
        m.z_basic_prediction(coords.astype(np.int64), feat, pred_z)
        dense = np.full((16, NX, NY), 0.5)
        dense[coords[::2, 2], coords[::2, 0], coords[::2, 1]] = feat[::2]
        m.z_basic_prediction_dense(coords.astype(np.int64), dense)
        Ed = rng.uniform(0, 5, (16, 3, NX, NY))
        pred_Ed = np.zeros((16, NX, NY))
        _, bl, br = seg_status_maps()
        m.E_basic_prediction_dense(Ed, rng.uniform(-600, 600, (16, NX, NY)), bl, br,
                                   tab.light_pos_curves, tab.light_sum_curves, pred_Ed)
        return maps, pred_E, pred_z, dense, pred_Ed

    _assert_equal_outputs(run(calibration), run(jax_cal))


# -- the evaluators ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(c for c in EVALUATORS if not c.startswith(("z_", "ez_"))))
def test_evaluator_matches_jax(case, caldb):
    assert_evaluators_match(case, caldb)
