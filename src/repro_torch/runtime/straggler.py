"""Straggler detection: per-step wall-clock watchdog (port of the
reference's runtime/straggler.py, framework-free: it runs as it is).

On a large fleet a single slow host stretches every synchronous collective.
The watchdog keeps an EMA + variance of step time; a step slower than
`mean + k*sigma` (and `min_ratio` x mean) is flagged, counted, and reported
to a callback — the hook where production deployments trigger mitigation
(re-shard away from the slow host, swap in a hot spare, or turn on backup
steps).  The detector itself is deterministic and unit-tested.
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional


class StragglerWatchdog:
    def __init__(self, *, k_sigma: float = 3.0, min_ratio: float = 1.5,
                 warmup: int = 5,
                 on_straggler: Optional[Callable[[int, float, float], None]] = None):
        self.k_sigma = k_sigma
        self.min_ratio = min_ratio
        self.warmup = warmup
        self.on_straggler = on_straggler
        self.mean = 0.0
        self.var = 0.0
        self.n = 0
        self.events: List[dict] = []
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, step: int) -> bool:
        dt = time.perf_counter() - self._t0
        return self.observe(step, dt)

    def observe(self, step: int, dt: float) -> bool:
        """Feed one step duration; returns True if flagged as straggler."""
        flagged = False
        if self.n >= self.warmup:
            sigma = max(self.var, 1e-12) ** 0.5
            thresh = max(self.mean + self.k_sigma * sigma,
                         self.mean * self.min_ratio)
            if dt > thresh:
                flagged = True
                self.events.append({"step": step, "dt": dt,
                                    "mean": self.mean, "thresh": thresh})
                if self.on_straggler:
                    self.on_straggler(step, dt, self.mean)
        if not flagged:            # don't poison the EMA with outliers
            alpha = 0.1 if self.n else 1.0
            delta = dt - self.mean
            self.mean += alpha * delta
            self.var = (1 - alpha) * (self.var + alpha * delta * delta)
        self.n += 1
        return flagged
