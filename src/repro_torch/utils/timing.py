"""Lightweight wall-clock instrumentation.

The paper reports drain time, transfer time, blocking checkpoint time and
total persist time separately (§4.2–4.5); every CRUM phase here is timed so
benchmarks can reproduce those splits.
"""
from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field


@dataclass
class Timings:
    """Accumulates named durations (seconds)."""

    totals: dict[str, float] = field(default_factory=lambda: defaultdict(float))
    counts: dict[str, int] = field(default_factory=lambda: defaultdict(int))

    def add(self, name: str, seconds: float) -> None:
        self.totals[name] += seconds
        self.counts[name] += 1

    def mean(self, name: str) -> float:
        c = self.counts.get(name, 0)
        return self.totals[name] / c if c else 0.0

    def summary(self) -> dict[str, dict[str, float]]:
        return {
            k: {"total_s": self.totals[k], "count": self.counts[k], "mean_s": self.mean(k)}
            for k in sorted(self.totals)
        }

    @contextmanager
    def measure(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)


class Timer:
    """Context manager returning elapsed seconds via ``.elapsed``."""

    def __enter__(self) -> "Timer":
        self._t0 = time.perf_counter()
        self.elapsed = 0.0
        return self

    def __exit__(self, *exc) -> None:
        self.elapsed = time.perf_counter() - self._t0
