"""Preemption handling and restart-with-restore (port of the reference's
runtime/fault_tolerance.py, framework-free: it runs as it is).

At fleet scale the training binary WILL be preempted and nodes WILL fail.
The loop contract here:

  * SIGTERM/SIGINT -> finish the in-flight step -> blocking checkpoint ->
    exit with RESTART_EXIT_CODE (the scheduler relaunches).
  * On relaunch, the driver restores the latest checkpoint and the
    step-indexed data pipeline resumes bitwise-exactly.
  * `run_with_restarts` is the in-process harness used by tests: it runs the
    step loop, injects/absorbs failures, restores, and continues — proving
    the restart path end-to-end without a cluster scheduler.
"""
from __future__ import annotations

import signal
import sys
from typing import Callable, Optional

RESTART_EXIT_CODE = 42


class PreemptionGuard:
    """Installs SIGTERM/SIGINT handlers that set a flag instead of killing
    the process mid-step.  Check `should_stop` at step boundaries."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.should_stop = False
        self._prev = {}
        self._signals = signals

    def __enter__(self):
        for s in self._signals:
            self._prev[s] = signal.signal(s, self._handler)
        return self

    def _handler(self, signum, frame):
        self.should_stop = True

    def __exit__(self, *exc):
        for s, h in self._prev.items():
            signal.signal(s, h)
        return False


def run_with_restarts(make_state: Callable[[], object],
                      step_fn: Callable[[object, int], object],
                      checkpointer, *, total_steps: int,
                      checkpoint_every: int = 10,
                      max_restarts: int = 3,
                      fail_at: Optional[Callable[[int], bool]] = None):
    """Fault-tolerant loop: run steps, checkpoint periodically, and on any
    exception restore from the latest checkpoint and continue (up to
    `max_restarts`).  `fail_at(step)` injects failures for tests.
    Returns (final_state, steps_executed, restarts)."""
    restarts = 0
    executed = 0
    while True:
        try:
            start = checkpointer.latest_step()
            if start is None:
                state, start = make_state(), 0
            else:
                state = checkpointer.restore(make_state())
            step = start
            while step < total_steps:
                if fail_at is not None and fail_at(step):
                    raise RuntimeError(f"injected failure at step {step}")
                state = step_fn(state, step)
                executed += 1
                step += 1
                if step % checkpoint_every == 0 or step == total_steps:
                    checkpointer.save(state, step)
            return state, executed, restarts
        except Exception:
            restarts += 1
            if restarts > max_restarts:
                raise
