"""Scheduling policies (copy of the reference's serving/scheduler.py
`SchedulerPolicy` and `FCFSPolicy`): pure host-side ordering and preemption
victim choice over `Task` objects."""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import List, Sequence

from repro_torch.serving.tasks import Task


class SchedulerPolicy(ABC):
    """Admission ordering + preemption victim selection."""

    name: str = "policy"

    @abstractmethod
    def admission_order(self, queue: Sequence[Task],
                        now: float) -> List[Task]:
        """The queue in the order admission should consider it (a new
        list)."""

    def select_victim(self, running: Sequence[Task], now: float) -> Task:
        """The running task to preempt when the KV pool is exhausted: the
        most recently admitted — it has the least progress to recompute."""
        return max(running, key=lambda t: t._seq)


class FCFSPolicy(SchedulerPolicy):
    """First-come-first-served."""

    name = "fcfs"

    def admission_order(self, queue: Sequence[Task],
                        now: float) -> List[Task]:
        return list(queue)
