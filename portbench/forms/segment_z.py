"""segment_z: ``segment_block`` of ``datasets/synthetic.py``: one row a
pulse (coords ``[N, 3]``: x, y, event; both PMTs' samples on [0, 1]) of
particle kind 0, labelled with its z on [0, 1]."""
import numpy as np

from portbench import gen


def make_chunk(rng: np.random.Generator, n_events: int, n_samples: int, traffic) -> gen.Chunk:
    lo, hi = traffic["multiplicity"]
    mult = gen.multiplicities(rng, n_events, int(lo), int(hi))
    ev = gen.make_events(rng, mult, n_samples, np.zeros(n_events, np.int64))
    z = (ev["z"] / gen.Z_SCALE + 0.5).astype(np.float32)
    return gen.Chunk(ev["coords"], (ev["waveforms"] / gen.MAX_RANGE).astype(np.float32), z,
                     n_events)
