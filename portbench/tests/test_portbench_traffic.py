"""The traffic generator: deterministic for a seed, the same amount of work
for every seed, and the synthetic module's rows."""
import numpy as np
import pytest

from portbench import gen

TRAFFIC = {"events": 200, "multiplicity": [1, 4], "pool": 2}


@pytest.mark.parametrize("form,n_samples", [("labelled_3d", 16), ("segment_z", 150)])
def test_a_seed_gives_the_same_pool(form, n_samples):
    a = gen.make_pool(2 ** 31 + 7, form, n_samples, TRAFFIC)
    b = gen.make_pool(2 ** 31 + 7, form, n_samples, TRAFFIC)
    c = gen.make_pool(2 ** 31 + 8, form, n_samples, TRAFFIC)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.coords, y.coords)
        np.testing.assert_array_equal(x.feats, y.feats)
        np.testing.assert_array_equal(x.labels, y.labels)
    assert not np.array_equal(a[0].feats[:10], c[0].feats[:10])


def test_balanced_multiplicities_are_the_same_for_every_seed():
    counts = set()
    for seed in (1, 2, 3):
        chunk = gen.make_pool(seed, "segment_z", 150, TRAFFIC)[0]
        per_event = np.bincount(chunk.coords[:, 2], minlength=200)
        counts.add(tuple(np.bincount(per_event)))
        assert chunk.n_events == 200 and per_event.min() >= 1 and per_event.max() <= 4
        # distinct sites within an event
        keys = chunk.coords[:, 2] * 1000 + chunk.coords[:, 0] * 20 + chunk.coords[:, 1]
        assert np.unique(keys).size == keys.size
    assert len(counts) == 1


def test_rows_3d_is_the_synthetic_modules():
    from waveformml_tpu_torch.datasets import synthetic

    rng = np.random.default_rng(5)
    ev = gen.make_events(rng, np.array([1, 3, 2, 4]), 16, np.array([0, 1, 0, 1]))
    ours = gen.rows_3d(ev["coords"], ev["waveforms"], 16)
    theirs = synthetic.rows_3d(ev["coords"], ev["waveforms"], 16)
    np.testing.assert_array_equal(ours[0], theirs[0])
    np.testing.assert_array_equal(ours[1], theirs[1])


def test_waveforms_follow_the_synthetic_pulse():
    """The vectorised pulse is ``synth_waveform_pair``'s without its noise."""
    from waveformml_tpu_torch.datasets import synthetic

    class Quiet:
        """A generator whose draws are fixed and whose noise is zero."""

        def __init__(self, rng):
            self.rng = rng

        def uniform(self, lo, hi, size=None):
            return np.full(size, 0.5 * (lo + hi)) if size is not None else 0.5 * (lo + hi)

        def normal(self, loc, scale, size):
            return np.zeros(size)

        def standard_normal(self, size, dtype=np.float64):
            return np.zeros(size, dtype)

        def random(self, size):
            return self.rng.random(size)

    ev = gen.make_events(Quiet(np.random.default_rng(0)), np.array([1]), 65, np.array([1]))
    want = synthetic.synth_waveform_pair(Quiet(None), 65, 5.25, 0.0, 1)
    np.testing.assert_allclose(ev["waveforms"][0], want, rtol=1e-5, atol=1e-3)
