"""Phase timers and metric counters, the counterpart of
``rebel_tpu/utils/timers.py``: named-phase wall-clock accumulators for
``timing/*`` and ``timing_pct/*`` metrics, and the fraction and maximum
accumulators of per-epoch metric dicts.  For device time use
``torch.profiler`` or CUDA events (``python -m rebel_tpu_torch.bench
--profile``); these timers read the host's clock.
"""

from __future__ import annotations

import time
from collections import defaultdict


class StopWatchTimer:
    """Start/stop accumulator."""

    def __init__(self, auto_start: bool = True):
        self.elapsed = 0.0
        self._started: float | None = None
        if auto_start:
            self.start()

    def start(self) -> None:
        self._started = time.time()

    def stop(self) -> None:
        if self._started is not None:
            self.elapsed += time.time() - self._started
            self._started = None

    @property
    def running_time(self) -> float:
        extra = time.time() - self._started if self._started is not None else 0
        return self.elapsed + extra


class MultiStopWatchTimer:
    """Time per named phase; starting a phase stops the previous one."""

    def __init__(self):
        self._timings: dict[str, float] = defaultdict(float)
        self._current: str | None = None
        self._started = 0.0

    def start(self, name: str) -> None:
        now = time.time()
        if self._current is not None:
            self._timings[self._current] += now - self._started
        self._current = name
        self._started = now

    def stop(self) -> None:
        if self._current is not None:
            self._timings[self._current] += time.time() - self._started
            self._current = None

    @property
    def timings(self) -> dict[str, float]:
        return dict(self._timings)

    def metrics(self, denominator: float = 1.0) -> dict[str, float]:
        """``timing/<phase>`` (seconds over ``denominator``) and
        ``timing_pct/<phase>`` (share of the total, in percent)."""
        out = {}
        total = 1e-5
        for k, v in self._timings.items():
            out[f"timing/{k}"] = v / denominator
            total += v
        for k, v in self._timings.items():
            out[f"timing_pct/{k}"] = v * 100 / total
        return out


class FractionCounter:
    """Weighted-average accumulator."""

    def __init__(self):
        self._num = 0.0
        self._denom = 0.0

    def update(self, numerator, denominator=1.0) -> None:
        self._num += float(numerator)
        self._denom += float(denominator)

    def value(self) -> float:
        return self._num / self._denom if self._denom else 0.0


class MaxCounter:
    """Running maximum."""

    def __init__(self):
        self._value: float | None = None

    def update(self, value) -> None:
        v = float(value)
        self._value = v if self._value is None else max(self._value, v)

    def value(self) -> float:
        return self._value if self._value is not None else 0.0
