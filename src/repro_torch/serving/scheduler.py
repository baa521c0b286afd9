"""Scheduling policies (copy of the reference's serving/scheduler.py): pure
host-side ordering, preemption victim choice, chunk budget and the goodput
levers (shed, degrade) over `Task` objects.

  FCFSPolicy            arrival order, youngest-admitted preemption victim.
  PriorityPolicy        effective priority = priority + age / aging_s, so a
                        starving low-priority task eventually outranks fresh
                        high-priority arrivals; preemption evicts the
                        lowest-effective-priority running task.
  ChunkedPrefillPolicy  FCFS order + `chunk_tokens`: prompts longer than the
                        budget prefill in fixed-size chunks interleaved with
                        decode steps, so admitting a long prompt never stalls
                        running slots for the whole prefill.
  DeadlinePolicy        earliest-deadline-first over `deadline_ms` slack,
                        plus the two goodput levers the engine exposes:
                        SHED queued requests whose TTFT deadline is
                        provably unattainable (a typed Rejection instead of
                        a guaranteed miss), and DEGRADE under queue
                        pressure (tree speculation shrunk to its chain,
                        then speculation off for newly admitted requests;
                        the chunk budget halved) before shedding.  Degrade
                        never changes tokens: speculation is lossless and
                        chunk width only moves prefill work in time.

Policies never touch device state, steps or caches."""
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

    # -- goodput hooks (no-ops outside DeadlinePolicy) ------------------
    def shed_candidates(self, queue: Sequence[Task],
                        now: float) -> List[Task]:
        """Queued tasks to drop with a typed Rejection because their SLO is
        provably unattainable.  Default: never shed."""
        return []

    def degrade_level(self, n_queued: int, n_slots: int) -> int:
        """0 = full service; >= 1 = the engine degrades (speculation off or
        shrunk, chunk budget shrunk) before any shedding.  Default: never
        degrade."""
        return 0

    def effective_chunk_tokens(self, level: int) -> Optional[int]:
        """The chunk budget at a degrade level (None = whole-prompt
        prefill at every level)."""
        return self.chunk_tokens

    def admission_annotation(self, task: Task, now: float) -> dict:
        """Trace-span args saying why a task admits now (a pure observer
        for serving/trace.py, never read by admission): the policy, and
        its ordering key where it has one."""
        return {"policy": self.name}


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

    def admission_annotation(self, task: Task, now: float) -> dict:
        return {"policy": self.name,
                "effective_priority": self.effective_priority(task, now)}


class ChunkedPrefillPolicy(FCFSPolicy):
    """FCFS admission, long prompts prefilled in `chunk_tokens`-sized
    pieces interleaved with decode steps.  Chunking changes when prefill
    work runs, never what it computes."""

    name = "chunked"

    def __init__(self, chunk_tokens: int = 32):
        if chunk_tokens < 1:
            raise ValueError(f"chunk_tokens must be >= 1: {chunk_tokens}")
        self.chunk_tokens = chunk_tokens


class DeadlinePolicy(SchedulerPolicy):
    """Earliest-deadline-first with load shedding and degrade: the goodput
    policy (requests/s meeting their SLO, not raw throughput).

    Admission runs in ascending `slack_ms` = deadline_ms - age (no-deadline
    tasks have infinite slack and keep arrival order after every deadlined
    one); preemption evicts the MOST slack.  Both sorts are stable, so
    equal-deadline traffic is exact FCFS.

    shed: a queued request with no first token whose `age +
    ttft_floor_ms` already exceeds its deadline cannot meet its TTFT SLO
    under any schedule; serving it would spend capacity on a guaranteed
    miss.  The default floor of 0 is pure expiry.

    degrade: a two-rung lossless ladder keyed to the generate backlog.
    Level 1 (backlog > `degrade_depth` requests a decode slot) shrinks
    token-tree speculation to single-branch chains and halves the chunk
    budget; level 2 (backlog > twice that) also serves newly admitted
    requests without speculation (per request, sticky).  An engine
    speculating in chains has no tree to shrink, so it applies the
    per-request rung from level 1.  Tokens never change on any rung."""

    name = "deadline"

    def __init__(self, chunk_tokens: Optional[int] = None,
                 shed: bool = True, ttft_floor_ms: float = 0.0,
                 degrade_depth: float = 2.0):
        if ttft_floor_ms < 0:
            raise ValueError(f"ttft_floor_ms must be >= 0: {ttft_floor_ms}")
        if degrade_depth < 0:
            raise ValueError(f"degrade_depth must be >= 0: {degrade_depth}")
        self.chunk_tokens = chunk_tokens
        self.shed = shed
        self.ttft_floor_ms = ttft_floor_ms
        self.degrade_depth = degrade_depth

    def admission_order(self, queue: Sequence[Task],
                        now: float) -> List[Task]:
        # stable: equal slack (and the no-deadline tail) keeps arrival order
        return sorted(queue, key=lambda t: t.slack_ms(now))

    def select_victim(self, running: Sequence[Task], now: float) -> Task:
        # the most slack; among equals, the youngest
        return max(running, key=lambda t: (t.slack_ms(now), t._seq))

    def shed_candidates(self, queue: Sequence[Task],
                        now: float) -> List[Task]:
        if not self.shed:
            return []
        # a non-empty output is a preempted request: its TTFT is decided,
        # and shedding it would throw away real progress for no SLO gain
        return [t for t in queue
                if t.deadline_ms is not None
                and not getattr(t, "output", None)
                and t.age_s(now) * 1e3 + self.ttft_floor_ms > t.deadline_ms]

    def degrade_level(self, n_queued: int, n_slots: int) -> int:
        thresh = self.degrade_depth * max(1, n_slots)
        if n_queued > 2 * thresh:
            return 2
        return 1 if n_queued > thresh else 0

    def effective_chunk_tokens(self, level: int) -> Optional[int]:
        if self.chunk_tokens is None or level <= 0:
            return self.chunk_tokens
        # halved once for both rungs, floored: a tiny chunk pass is all
        # padding
        return max(8, self.chunk_tokens // 2)

    def admission_annotation(self, task: Task, now: float) -> dict:
        ann = {"policy": self.name}
        slack = task.slack_ms(now)
        if slack != float("inf"):
            ann["edf_slack_ms"] = slack
        return ann


POLICIES = {
    "fcfs": FCFSPolicy,
    "priority": PriorityPolicy,
    "chunked": ChunkedPrefillPolicy,
    "deadline": DeadlinePolicy,
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
        p = DeadlinePolicy(chunk_tokens=chunk_tokens)
    else:
        raise KeyError(f"unknown policy {name!r}; known: {sorted(POLICIES)}")
    p.cache_aware = cache_aware
    return p
