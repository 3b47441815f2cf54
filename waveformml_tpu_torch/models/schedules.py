"""Channel-schedule helpers of the conv block generators
(counterpart of waveformml_tpu/models/schedules.py)."""
from __future__ import annotations

from math import floor
from typing import List


def get_frame_expansion(initial_number: int, factor: float, n: int,
                        use_round: bool = False) -> List[int]:
    frames = [initial_number]
    diff = float(int(round(factor * initial_number)) - initial_number) / n
    for _ in range(n):
        nxt = frames[-1] + diff
        frames.append(int(round(nxt)) if use_round else int(floor(nxt)))
    return frames[1:]


def get_frame_contraction(initial_number: int, nout: int, n: int,
                          use_round: bool = False) -> List[int]:
    frames = [initial_number]
    diff = float(initial_number - nout) / n
    for _ in range(n):
        nxt = frames[-1] - diff
        frames.append(int(round(nxt)) if use_round else int(floor(nxt)))
    return frames[1:]
