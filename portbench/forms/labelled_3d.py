"""labelled_3d: ``labelled_block_3d`` of ``datasets/synthetic.py``: the
(x, y, t) rows of ``rows_3d`` (coords ``[N, 4]``: x, y, t, event; both PMTs'
samples at t, on [0, 1]), labelled with the events' particle kinds, each
kind half of the events."""
import numpy as np

from portbench import gen


def make_chunk(rng: np.random.Generator, n_events: int, n_samples: int, traffic) -> gen.Chunk:
    lo, hi = traffic["multiplicity"]
    mult = gen.multiplicities(rng, n_events, int(lo), int(hi))
    kinds = gen.particle_kinds(rng, n_events)
    ev = gen.make_events(rng, mult, n_samples, kinds)
    c, w = gen.rows_3d(ev["coords"], ev["waveforms"], n_samples)
    return gen.Chunk(c, (w / gen.MAX_RANGE).astype(np.float32), kinds.astype(np.int64), n_events)
