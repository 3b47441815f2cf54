"""Per-section wall-clock profiler writing ``profile_results.txt`` (the port's
copy of waveformml_tpu/utils/profiler.py).

``Trainer(..., profiler=True)`` times its named sections with a
``SimpleProfiler`` (``get_train_batch``, ``run_training_step``,
``evaluation_step``, PyTorch Lightning's action names, so that tooling
reading the file keeps working) and writes the table beside the
``torch.profiler`` trace of the fit: count, total, mean and share of the
profiler's lifetime per action, sorted by total time. Each section is a
``utils.tracing.span`` of the action's name, so that it also sits in the
profiler's trace.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, List, Tuple

from waveformml_tpu_torch.utils import tracing


class SimpleProfiler:
    """Accumulates wall-clock time per named action."""

    def __init__(self):
        self._records: Dict[str, List[float]] = {}
        self._open: Dict[str, tracing.span] = {}
        self._t0 = time.time()

    def start(self, name: str) -> None:
        self._open[name] = tracing.span(name).open()

    def stop(self, name: str) -> None:
        span = self._open.pop(name, None)
        if span is None:
            return
        span.close()
        self._records.setdefault(name, []).append(span.seconds)

    @contextmanager
    def profile(self, name: str):
        self.start(name)
        try:
            yield
        finally:
            self.stop(name)

    def rows(self) -> List[Tuple[str, int, float, float]]:
        """(action, count, total_s, mean_s) sorted by total time desc."""
        out = [(k, len(v), sum(v), sum(v) / len(v))
               for k, v in self._records.items() if v]
        return sorted(out, key=lambda r: -r[2])

    def summary(self) -> str:
        total = time.time() - self._t0
        lines = [
            "Profiler Report",
            "",
            f"{'Action':<28}|{'Mean duration (s)':>20}|{'Num calls':>12}"
            f"|{'Total time (s)':>16}|{'Percentage %':>14}",
            "-" * 94,
            f"{'Total':<28}|{'-':>20}|{'1':>12}|{total:>16.5f}|{100.0:>14.1f}",
            "-" * 94,
        ]
        for name, count, tot, mean in self.rows():
            pct = 100.0 * tot / total if total > 0 else 0.0
            lines.append(f"{name:<28}|{mean:>20.5g}|{count:>12}"
                         f"|{tot:>16.5f}|{pct:>14.1f}")
        return "\n".join(lines) + "\n"

    def describe(self, path: str) -> None:
        """Write the summary table to ``path`` (profile_results.txt)."""
        with open(path, "w") as f:
            f.write(self.summary())
