"""Continuous-batching inference engine (port of the reference's
serving/engine.py, synchronous loop): queue -> SchedulerPolicy ->
ModelRunner.

A fixed decode batch of B slots runs lockstep AR steps; finished rows are
replaced at once by prefilling queued requests, batched per length bucket;
KV memory is block-paged with recompute preemption when the pool runs out;
`generate()` streams `TokenEvent`s and `stats()` returns `EngineStats`.
EncodeTasks (one pooled, cache-free pass each, the paper's encoder
topology) take no slot and no block: each engine step first runs one
same-bucket, same-pooling batch of them, then admits generate traffic.
The engine runs on the GPU unless `device="cpu"` is passed.
`weight_dtype="int8"` quantizes the dense GEMM weights per output channel
once, at construction; `kv_dtype="int8"` stores the paged KV pools in int8
with per-block-per-head scales (`serving/runner.py`).

`scheduler=` takes any SchedulerPolicy (FCFS by default; priority with
aging; `ChunkedPrefillPolicy(n)`: prompts longer than n tokens prefill in
n-token pieces, one piece a step between decode steps, so a long admission
never stalls the running slots for its whole prefill).  `prefix_cache=True`
shares the KV blocks of cached prompt prefixes across requests: a warm
admission prefills only its uncached suffix; `cache_blocks` caps the blocks
the index may hold.  Both need a config whose every KV segment is paged
(`runner.supports_chunked`); the others prefill whole prompts and say why
(`runner.chunk_unsupported_reason`, `runner.prefix_cache_reason`).

`spec=SpecConfig(draft=..., k=..., branches=...)` turns on speculative
decoding (`serving/spec.py`): a draft LM (`draft_params`, the target itself
for draft="self", else a seeded init) proposes k tokens a round and one
target verify pass commits 1 to k + 1 of them a slot, chain or token tree;
`decode()` is replaced by `runner.spec_decode()`.  The reference's
`draft_checkpoint=` (draft params from a checkpoint directory) waits for
the port's checkpointer and is not an argument here.
"""
from __future__ import annotations

import time
from typing import Iterator, List, Optional

from repro_torch.serving.runner import ModelRunner
from repro_torch.serving.sampling import validate_sampling
from repro_torch.serving.scheduler import FCFSPolicy, SchedulerPolicy
from repro_torch.serving.spec import SpecConfig
from repro_torch.serving.stats import EngineStats
from repro_torch.serving.tasks import (EncodeTask, GenerateTask, Request,
                                       Task, TokenEvent, validate_task)


class InferenceEngine:
    def __init__(self, cfg, params, *, batch_size: int = 4,
                 max_seq: int = 256, policy=None, min_bucket: int = 8,
                 block_size: int = 16, kv_pool_blocks: Optional[int] = None,
                 scheduler: Optional[SchedulerPolicy] = None,
                 fuse_epilogues: bool = True, weight_dtype: str = "bfloat16",
                 kv_dtype: Optional[str] = None, prefix_cache: bool = False,
                 cache_blocks: Optional[int] = None,
                 spec: Optional[SpecConfig] = None, draft_params=None,
                 device=None):
        # `policy` is the PRECISION policy (the reference's name); the
        # scheduling policy is `scheduler`
        self.runner = ModelRunner(cfg, params, batch_size=batch_size,
                                  max_seq=max_seq, policy=policy,
                                  min_bucket=min_bucket,
                                  block_size=block_size,
                                  kv_pool_blocks=kv_pool_blocks,
                                  fuse_epilogues=fuse_epilogues,
                                  weight_dtype=weight_dtype,
                                  kv_dtype=kv_dtype,
                                  prefix_cache=prefix_cache,
                                  cache_blocks=cache_blocks, spec=spec,
                                  draft_params=draft_params, device=device)
        self.scheduler = scheduler or FCFSPolicy()
        self.queue: List[GenerateTask] = []
        self.encode_queue: List[EncodeTask] = []
        self.completed: List[Task] = []
        self._stats = self._fresh_stats()
        self._prefix_base = self._prefix_snapshot()
        self._t_last_decode: Optional[float] = None

    # -- delegated runner state ----------------------------------------
    @property
    def allocator(self):
        return self.runner.allocator

    @property
    def slots(self):
        return self.runner.slots

    @property
    def prefix_cache(self):
        return self.runner.prefix_cache

    def _fresh_stats(self) -> EngineStats:
        st = EngineStats(batch_size=self.runner.B)
        st.kv_pool_blocks = self.runner.layout.num_blocks
        st.kv_block_size = self.runner.layout.block_size
        st.weight_dtype = self.runner.weight_dtype
        st.kv_dtype = self.runner.kv_dtype
        st.weight_bytes_per_device = self.runner.weight_bytes_per_device()
        st.kv_pool_bytes = self.runner.kv_pool_bytes()
        return st

    # -- admission -----------------------------------------------------
    def submit(self, task: Task):
        """Queue a GenerateTask (alias: Request) or an EncodeTask."""
        validate_task(task)
        n = len(task.prompt)
        encode = isinstance(task, EncodeTask)
        # an encode pass reserves no decode position; both reserve a VLM's
        # patch prefix
        cap = (self.runner.max_seq - self.runner._n_prefix if encode
               else self.runner.prompt_cap)
        if not 0 < n <= cap:
            raise ValueError(f"prompt length {n} not in [1, {cap}] "
                             f"(max_seq={self.runner.max_seq}, "
                             f"patch prefix={self.runner._n_prefix})")
        if not encode:
            if task.max_new_tokens < 1:
                raise ValueError(f"max_new_tokens must be >= 1 (the prefill "
                                 f"emits the first token): "
                                 f"{task.max_new_tokens}")
            validate_sampling(task.sampling)
            spec = self.runner.spec
            if (spec is not None and spec.acceptance == "greedy"
                    and not task.sampling.is_greedy):
                raise ValueError(
                    f"request {task.uid} samples (temperature="
                    f"{task.sampling.temperature}) but SpecConfig "
                    f"acceptance='greedy' serves greedy traffic only; "
                    f"use acceptance='lossless' for exact sampled "
                    f"speculation")
        task.prompt_len = n
        task._t_submit = time.perf_counter()
        (self.encode_queue if encode else self.queue).append(task)
        self._stats.requests_submitted += 1

    def _first_admission(self, task: Task):
        task.queue_wait_ms = (time.perf_counter() - task._t_submit) * 1e3
        self._stats.add_queue_wait_ms(task.queue_wait_ms)

    def _chunk_budget(self) -> Optional[int]:
        """The chunked-prefill token budget of an engine step (None:
        whole-prompt prefill)."""
        return self.scheduler.effective_chunk_tokens(0)

    def _chunkable(self, task: GenerateTask) -> bool:
        ct = self._chunk_budget()
        return (ct is not None and self.runner.supports_chunked
                and self.runner.full_len(task) > ct)

    def _next_group(self, order: List[GenerateTask], max_n: int):
        """Up to `max_n` tasks sharing the policy head's length bucket, each
        with its pool blocks allocated (all-or-nothing per task)."""
        runner = self.runner
        head_bucket = runner.bucket_for(runner.full_len(order[0]))
        cands = [t for t in order
                 if runner.bucket_for(runner.full_len(t)) == head_bucket]
        group = []
        for task in cands[:max_n]:
            blk = runner.alloc_for(task)
            if blk is None:
                break
            group.append((task, blk))
        if not group:
            self._pool_too_small_check(order[0])
        return group

    def _pool_too_small_check(self, head: GenerateTask):
        """Admission got nothing: fatal only when nothing is running."""
        runner = self.runner
        if runner.has_running():
            return
        raise RuntimeError(
            f"KV pool too small: request {head.uid} needs "
            f"{runner.blocks_needed(head)} blocks, pool has "
            f"{runner.allocator.num_blocks} ({runner.allocator.num_free} "
            f"free) and no running request can be preempted to free more")

    def _admit(self, fresh: List) -> int:
        """Admit queued tasks into free slots in the scheduler's order: a
        prefix-cache hit seats with the shared blocks and prefills only its
        suffix; a prompt over the chunk budget parks in its slot and
        advances a piece a step (`_advance_chunks`); the rest prefill in
        same-bucket groups, one pass a group."""
        runner = self.runner
        admitted = 0
        while True:
            free = runner.free_slots()
            if not free or not self.queue:
                return admitted
            order = self.scheduler.admission_order(self.queue,
                                                   time.perf_counter())
            if runner.prefix_cache is not None:
                order = self.scheduler.cached_order(
                    order, runner.cached_tokens_for)
            head = order[0]
            if runner.prefix_cache is not None:
                res = runner.admit_cached(head, free[0])
                if res is False:
                    if runner.has_running():
                        return admitted    # retirement will free blocks
                    # nothing runs and the warm layout does not fit (the
                    # copy-on-write duplicate when the pool exactly fits
                    # the request): flush the cache and admit cold
                    runner.prefix_cache.clear()
                    res = None
                if res:
                    self.queue.remove(head)
                    if not head.output:
                        self._first_admission(head)
                    admitted += 1
                    ct = self._chunk_budget()
                    suffix = runner.full_len(head) - head.prefilled
                    if ct is not None and suffix > ct:
                        continue           # parked: _advance_chunks
                    # the whole suffix now, in one bucketed chunk pass
                    width = runner.bucket_for(suffix)
                    while runner.prefilling[free[0]]:
                        ev = runner.chunk_step(head, width, self._stats)
                        if ev is not None:
                            fresh.append(ev)
                    continue
            if self._chunkable(head):
                blk = runner.alloc_for(head)
                if blk is None:
                    self._pool_too_small_check(head)
                    return admitted
                self.queue.remove(head)
                if not head.output:
                    self._first_admission(head)
                runner.begin_chunked(head, blk, free[0])
                admitted += 1
                continue
            group = self._next_group(order, len(free))
            if not group:
                return admitted
            for task, _ in group:
                self.queue.remove(task)
                if not task.output:
                    self._first_admission(task)
            fresh.extend(runner.prefill(group, free, self._stats))
            admitted += len(group)

    def _run_encode(self) -> int:
        """Run ONE encode batch: the scheduler's head EncodeTask and the
        queued ones of its bucket and pooling, up to the batch size.  One
        batch per engine step keeps a long encode backlog from starving
        decode."""
        if not self.encode_queue:
            return 0
        runner = self.runner
        order = self.scheduler.admission_order(self.encode_queue,
                                               time.perf_counter())
        head = order[0]
        bucket = runner.encode_bucket_for(head.prompt_len)
        group = [t for t in order
                 if runner.encode_bucket_for(t.prompt_len) == bucket
                 and t.pooling == head.pooling][:runner.B]
        for task in group:
            self.encode_queue.remove(task)
            self._first_admission(task)
        runner.encode(group, self._stats)
        self.completed.extend(group)
        self._stats.requests_completed += len(group)
        return len(group)

    # -- retirement ------------------------------------------------------
    def _retire(self):
        runner = self.runner
        for b, task in enumerate(runner.slots):
            if task is None or runner.prefilling[b]:
                continue
            tok = task.output[-1]
            if (len(task.output) >= task.max_new_tokens
                    or (task.eos_id is not None and tok == task.eos_id)
                    or int(runner.pos[b]) >= runner.max_seq - 1):
                task.done = True
                task.latency_ms = (time.perf_counter() - task._t_submit) * 1e3
                n = len(task.output)
                task.tpot_ms = ((task.latency_ms - task.ttft_ms) / (n - 1)
                                if n > 1 else 0.0)
                if n > 1:
                    self._stats.add_tpot_ms(task.tpot_ms)
                self.completed.append(task)
                self._stats.requests_completed += 1
                runner.release_slot(b)

    # -- engine loop ------------------------------------------------------
    def _advance_chunks(self, fresh: List):
        """Chunked-prefill advancement under a per-step token budget shared
        by the prefilling slots (oldest admitted first): several long
        admissions in flight still cost about one budget of prefill work
        between two decode steps.  Every call is one full-width pass (a
        short last piece is padded), so the budget is spent per call."""
        runner = self.runner
        ct = self._chunk_budget()
        budget = ct or 0
        for task in sorted((runner.slots[b] for b in range(runner.B)
                            if runner.slots[b] is not None
                            and runner.prefilling[b]),
                           key=lambda t: t._seq):
            if budget <= 0:
                break
            ev = runner.chunk_step(task, ct, self._stats)
            budget -= ct
            if ev is not None:
                fresh.append(ev)

    def step(self) -> List[TokenEvent]:
        """One engine iteration: one encode batch -> admit -> retire ->
        chunk advance -> retire -> AR step -> retire.  Returns the
        TokenEvents produced (EncodeTasks carry their result in
        `.embedding`)."""
        runner = self.runner
        fresh: List = []
        self._run_encode()
        while True:
            n_done = len(self.completed)
            admitted = self._admit(fresh)
            self._retire()
            if not self.queue or not runner.free_slots():
                break
            if not admitted and len(self.completed) == n_done:
                break
        self._advance_chunks(fresh)
        self._retire()         # a last piece's token may end its request
        if runner.decoding_slots():
            victim = lambda running: self.scheduler.select_victim(
                running, time.perf_counter())
            # speculation needs the verify chunk's blocks up front: the
            # lookahead extends each slot's need to pos + its depth
            la = runner.spec_lookahead() if runner.spec else None
            for task in runner.ensure_decode_blocks(victim, self._stats,
                                                    lookahead=la):
                self.queue.insert(0, task)
            if runner.decoding_slots():
                t0 = time.perf_counter()
                if self._t_last_decode is not None:
                    # the time decoding slots sat idle since the last AR
                    # step: admission work between decode steps (chunked
                    # prefill exists to bound it)
                    self._stats.add_decode_stall_ms(
                        (t0 - self._t_last_decode) * 1e3)
                fresh.extend(runner.spec_decode(self._stats) if runner.spec
                             else runner.decode(self._stats))
                self._t_last_decode = time.perf_counter()
                self._retire()
        if not runner.decoding_slots():
            self._t_last_decode = None    # idle gaps are not decode stalls
        return [TokenEvent(task.uid, task.output[i],
                           task.done and i == len(task.output) - 1)
                for task, i in fresh]

    def has_work(self) -> bool:
        return (bool(self.queue) or bool(self.encode_queue)
                or self.runner.has_running())

    def generate(self, max_steps: int = 10_000) -> Iterator[TokenEvent]:
        """Run engine steps until queue and slots drain, yielding each token
        the moment its step completes."""
        for _ in range(max_steps):
            if not self.has_work():
                return
            yield from self.step()

    def run(self, max_steps: int = 10_000) -> List[Task]:
        """Drain `generate()`; returns the tasks completed by this call."""
        start = len(self.completed)
        for _ in self.generate(max_steps):
            pass
        return self.completed[start:]

    # -- telemetry --------------------------------------------------------
    def _prefix_snapshot(self):
        """The prefix cache's counters are cumulative on the cache and the
        runner; `stats()` reports them since the last reset."""
        pc = self.runner.prefix_cache
        if pc is None:
            return None
        return (pc.lookups, pc.hits, pc.hit_tokens, pc.evicted_blocks,
                self.runner.cow_copies)

    def stats(self) -> EngineStats:
        self._stats.peak_blocks_used = self.runner.allocator.peak_used
        pc = self.runner.prefix_cache
        if pc is not None:
            base = self._prefix_base
            self._stats.prefix_lookups = pc.lookups - base[0]
            self._stats.prefix_hits = pc.hits - base[1]
            self._stats.cached_prefix_tokens = pc.hit_tokens - base[2]
            self._stats.evicted_blocks = pc.evicted_blocks - base[3]
            self._stats.cow_copies = self.runner.cow_copies - base[4]
            self._stats.cached_blocks = pc.cached_blocks
        return self._stats

    def reset_stats(self):
        """Drop the accumulated telemetry, keeping the built steps and the
        prefix cache's contents."""
        self.runner.allocator.peak_used = self.runner.allocator.num_used
        self._stats = self._fresh_stats()
        self._prefix_base = self._prefix_snapshot()
        self._t_last_decode = None    # a stall never spans a reset


__all__ = ["InferenceEngine", "Request", "GenerateTask", "EncodeTask",
           "TokenEvent"]
