"""Scheduling policies (copy of the reference's serving/scheduler.py, less
its deadline policy): pure host-side ordering, preemption victim choice and
chunk budget over `Task` objects.

  FCFSPolicy            arrival order, youngest-admitted preemption victim.
  PriorityPolicy        effective priority = priority + age / aging_s, so a
                        starving low-priority task eventually outranks fresh
                        high-priority arrivals; preemption evicts the
                        lowest-effective-priority running task.
  ChunkedPrefillPolicy  FCFS order + `chunk_tokens`: prompts longer than the
                        budget prefill in fixed-size chunks interleaved with
                        decode steps, so admitting a long prompt never stalls
                        running slots for the whole prefill.

The reference's `DeadlinePolicy` (EDF with shedding and degrade) is not
ported; `make_policy("deadline")` says so."""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import List, Optional, Sequence

from repro_torch.serving.tasks import Task


class SchedulerPolicy(ABC):
    """Admission ordering + preemption victim selection.

    `chunk_tokens`: None => whole-prompt prefill; an int => prompts longer
    than it prefill at most this many tokens a pass between decode steps
    (on configs that can chunk: `ModelRunner.supports_chunked`)."""

    name: str = "policy"
    chunk_tokens: Optional[int] = None
    # cache-aware admission (prefix cache only): stable re-sort of the
    # admission order by descending cached-prefix length.  Off by default.
    cache_aware: bool = False

    @abstractmethod
    def admission_order(self, queue: Sequence[Task],
                        now: float) -> List[Task]:
        """The queue in the order admission should consider it (a new
        list)."""

    def cached_order(self, order: List[Task], cached_tokens) -> List[Task]:
        """Apply cache-aware admission to an `admission_order` result.
        `cached_tokens(task) -> int` peeks into the prefix cache (no LRU
        touch, no hit-rate count).  The sort is stable: ties keep the
        policy's own order."""
        if not self.cache_aware:
            return order
        return sorted(order, key=lambda t: -cached_tokens(t))

    def select_victim(self, running: Sequence[Task], now: float) -> Task:
        """The running task to preempt when the KV pool is exhausted: the
        most recently admitted — it has the least progress to recompute."""
        return max(running, key=lambda t: t._seq)

    def effective_chunk_tokens(self, level: int) -> Optional[int]:
        """The chunk budget at a degrade level (None = whole-prompt
        prefill).  Only the reference's deadline policy changes it with
        the level."""
        return self.chunk_tokens


class FCFSPolicy(SchedulerPolicy):
    """First-come-first-served."""

    name = "fcfs"

    def admission_order(self, queue: Sequence[Task],
                        now: float) -> List[Task]:
        return list(queue)


class PriorityPolicy(SchedulerPolicy):
    """Priority + age ordering with bounded inversion:
    effective(t) = t.priority + t.age_s(now) / aging_s, plus up to
    `deadline_boost` as a task's `deadline_ms` approaches.  A task of
    priority p waiting longer than aging_s * (q - p) seconds outranks a
    fresh task of priority q."""

    name = "priority"
    aging_s: float = 10.0
    deadline_boost: float = 1.0

    def effective_priority(self, task: Task, now: float) -> float:
        p = task.priority + task.age_s(now) / self.aging_s
        if task.deadline_ms is not None and task.deadline_ms > 0:
            urgency = min(1.0, task.age_s(now) * 1e3 / task.deadline_ms)
            p += self.deadline_boost * urgency
        return p

    def admission_order(self, queue: Sequence[Task],
                        now: float) -> List[Task]:
        # stable sort: equal effective priority keeps arrival order
        return sorted(queue, key=lambda t: -self.effective_priority(t, now))

    def select_victim(self, running: Sequence[Task], now: float) -> Task:
        # the least important; among equals, the youngest
        return min(running, key=lambda t: (self.effective_priority(t, now),
                                           -t._seq))


class ChunkedPrefillPolicy(FCFSPolicy):
    """FCFS admission, long prompts prefilled in `chunk_tokens`-sized
    pieces interleaved with decode steps.  Chunking changes when prefill
    work runs, never what it computes."""

    name = "chunked"

    def __init__(self, chunk_tokens: int = 32):
        if chunk_tokens < 1:
            raise ValueError(f"chunk_tokens must be >= 1: {chunk_tokens}")
        self.chunk_tokens = chunk_tokens


POLICIES = {
    "fcfs": FCFSPolicy,
    "priority": PriorityPolicy,
    "chunked": ChunkedPrefillPolicy,
}


def make_policy(name: str, *, chunk_tokens: Optional[int] = None,
                cache_aware: bool = False) -> SchedulerPolicy:
    """CLI-friendly factory (launch/serve.py --policy)."""
    if name == "fcfs":
        p = FCFSPolicy()
    elif name == "priority":
        p = PriorityPolicy()
    elif name == "chunked":
        p = ChunkedPrefillPolicy(chunk_tokens or 32)
    elif name == "deadline":
        raise ValueError("policy 'deadline' (DeadlinePolicy: EDF with "
                         "shedding and degrade) is not ported yet")
    else:
        raise KeyError(f"unknown policy {name!r}; known: {sorted(POLICIES)}")
    p.cache_aware = cache_aware
    return p
