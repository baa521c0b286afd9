"""Continuous-batching inference engine (port of the reference's
serving/engine.py): queue -> SchedulerPolicy -> ModelRunner.

A fixed decode batch of B slots runs lockstep AR steps; finished rows are
replaced at once by prefilling queued requests, batched per length bucket;
KV memory is block-paged with recompute preemption when the pool runs out;
`generate()` streams `TokenEvent`s and `stats()` returns `EngineStats`.
EncodeTasks (one pooled, cache-free pass each, the paper's encoder
topology) take no slot and no block: each engine step first runs one
same-bucket, same-pooling batch of up to `encode_batch` of them (the decode
batch size by default), then admits generate traffic.
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
`decode()` is replaced by `runner.spec_decode()`.  `draft_checkpoint=`
(needs `spec=`, exclusive with `draft_params=`) restores the draft's params
from a `Checkpointer` directory, a tree of the resolved draft config at
the target params' dtype, as the reference's `_restore_draft` does.

`overlap=True` runs the overlapped host loop: the engine dispatches a
decode step and runs host scheduling and admission (and, in the steady
state, the next dispatch, chained on the device) before fetching the
step's tokens, hiding host work under device time; tokens are identical
to the synchronous loop's, greedy and sampled.  Speculation never
pipelines.  `scheduler=DeadlinePolicy(...)` sheds queued requests whose
deadline has provably passed (each gets a typed `Rejection` and lands in
`shed` and `completed`) and degrades under backlog: token trees shrink to
their chain, then newly admitted requests speculate no more
(`task.degraded`), the chunk budget halves.  `tracer=` (serving/trace.py)
records request lifecycles and step spans; with None every hook is one
falsy branch.
"""
from __future__ import annotations

import time
from typing import Iterator, List, Optional

from repro_torch.analysis.roofline import decoder_flops_per_token
from repro_torch.serving.runner import DecodeHandle, ModelRunner
from repro_torch.serving.sampling import validate_sampling
from repro_torch.serving.scheduler import FCFSPolicy, SchedulerPolicy
from repro_torch.serving.spec import SpecConfig
from repro_torch.serving.stats import EngineStats
from repro_torch.serving.tasks import (EncodeTask, GenerateTask, Rejection,
                                       Request, Task, TokenEvent,
                                       validate_task)


class InferenceEngine:
    def __init__(self, cfg, params, *, batch_size: int = 4,
                 max_seq: int = 256, policy=None, min_bucket: int = 8,
                 block_size: int = 16, kv_pool_blocks: Optional[int] = None,
                 scheduler: Optional[SchedulerPolicy] = None,
                 fuse_epilogues: bool = True, weight_dtype: str = "bfloat16",
                 kv_dtype: Optional[str] = None, prefix_cache: bool = False,
                 cache_blocks: Optional[int] = None,
                 spec: Optional[SpecConfig] = None, draft_params=None,
                 draft_checkpoint: Optional[str] = None,
                 device=None, encode_batch: Optional[int] = None,
                 overlap: bool = False, tracer=None):
        # `policy` is the PRECISION policy (the reference's name); the
        # scheduling policy is `scheduler`
        if encode_batch is not None and encode_batch < 1:
            raise ValueError(f"encode_batch must be >= 1: {encode_batch}")
        if draft_checkpoint is not None:
            if spec is None:
                raise ValueError(
                    "draft_checkpoint requires a SpecConfig (`spec=`)")
            if draft_params is not None:
                raise ValueError(
                    "pass draft_params OR draft_checkpoint, not both")
            draft_params = self._restore_draft(cfg, params, spec,
                                               draft_checkpoint, device)
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
                                  draft_params=draft_params, device=device,
                                  tracer=tracer)
        self.tracer = tracer
        self.scheduler = scheduler or FCFSPolicy()
        self.encode_batch = encode_batch or batch_size
        self.queue: List[GenerateTask] = []
        self.encode_queue: List[EncodeTask] = []
        self.completed: List[Task] = []
        # requests dropped unserved by the scheduler's shed decision, each
        # with a typed `rejection` (also in `completed`, so that every
        # submitted uid resolves)
        self.shed: List[Task] = []
        self.overlap = overlap
        self._pending: Optional[DecodeHandle] = None
        # overlapped steps dispatched before the previous step's fetch,
        # chained on its outputs (the fast path)
        self.fast_dispatches = 0
        self._degrade = 0                  # the scheduler's degrade level
        self._stats = self._fresh_stats()
        self._prefix_base = self._prefix_snapshot()
        self._t_last_decode: Optional[float] = None

    @staticmethod
    def _restore_draft(cfg, params, spec: SpecConfig, directory: str,
                       device):
        """The draft's params from a Checkpointer directory: the resolved
        draft config's tree at the target params' dtype (leaf count and
        shapes checked by restore: a mismatched checkpoint fails loudly),
        on the engine's device."""
        from repro_torch.checkpoint import Checkpointer
        from repro_torch.device import resolve_device
        from repro_torch.models import lm
        from repro_torch.models.params import meta_tree, tree_flatten
        from repro_torch.serving.spec import resolve_draft
        dcfg = resolve_draft(spec, cfg)
        pdtype = tree_flatten(params)[0][0].dtype
        like = meta_tree(lm.lm_param_shapes(dcfg), pdtype)
        return Checkpointer(directory).restore(like,
                                               device=resolve_device(device))

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
        # per-token FLOP / byte constants of phase_util()'s MFU / MBU
        # (analysis/roofline.py)
        st.model_flops_per_token = decoder_flops_per_token(self.runner.cfg)
        layout = self.runner.layout
        st.kv_bytes_per_token = st.kv_pool_bytes / (layout.num_blocks
                                                    * layout.block_size)
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
        if self.tracer:
            ann = {"prompt_len": n}
            if task.deadline_ms is not None:
                ann["deadline_ms"] = task.deadline_ms
            self.tracer.instant("submit", task._t_submit, tid=task.uid,
                                **ann)

    def _first_admission(self, task: Task):
        now = time.perf_counter()
        task.queue_wait_ms = (now - task._t_submit) * 1e3
        self._stats.add_queue_wait_ms(task.queue_wait_ms)
        if self.tracer:
            self.tracer.request_span(
                task.uid, "queue", task._t_submit, now,
                queue_wait_ms=task.queue_wait_ms,
                **self.scheduler.admission_annotation(task, now))

    def _chunk_budget(self) -> Optional[int]:
        """The chunked-prefill token budget of an engine step at the current
        degrade level (None: whole-prompt prefill)."""
        return self.scheduler.effective_chunk_tokens(self._degrade)

    def _note_admitted(self, task: GenerateTask):
        """The degrade ladder's per-request rung: a generate task admitted
        under pressure is served without speculation (spec_lookahead
        proposes nothing for it: exact, no lookahead), for its whole
        life.  A tree runner's first rung only shrinks its trees to chains
        (`step` sets runner._tree_chain_only), so its per-request rung
        waits for level 2."""
        thresh = 2 if self.runner.tree_branches > 1 else 1
        if (self._degrade >= thresh and self.runner.spec is not None
                and not task.degraded):
            task.degraded = True
            self._stats.requests_degraded += 1
            if self.tracer:
                self.tracer.instant("degrade", time.perf_counter(),
                                    tid=task.uid, rung=self._degrade)

    def _shed_expired(self):
        """Drop the queued requests whose SLO the policy proves
        unattainable: each gets a typed Rejection and done=True, and lands
        in `shed` and `completed` unserved."""
        cands = self.scheduler.shed_candidates(
            self.queue + self.encode_queue, time.perf_counter())
        for task in cands:
            (self.encode_queue if isinstance(task, EncodeTask)
             else self.queue).remove(task)
            task.rejection = Rejection(
                "slo_unattainable",
                f"deadline_ms={task.deadline_ms:.1f} already exceeded "
                f"after {task.age_s() * 1e3:.1f}ms in queue "
                f"(policy={self.scheduler.name})")
            task.done = True
            self.shed.append(task)
            self.completed.append(task)
            self._stats.record_shed(task)
            if self.tracer:
                self.tracer.request_span(
                    task.uid, "shed", task._t_submit, time.perf_counter(),
                    reason=task.rejection.kind,
                    detail=task.rejection.detail)

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
                    self._note_admitted(head)
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
                self._note_admitted(head)
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
                self._note_admitted(task)
            fresh.extend(runner.prefill(group, free, self._stats))
            admitted += len(group)

    def _run_encode(self) -> int:
        """Run ONE encode batch: the scheduler's head EncodeTask and the
        queued ones of its bucket and pooling, up to `encode_batch`.  One
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
                 and t.pooling == head.pooling][:self.encode_batch]
        for task in group:
            self.encode_queue.remove(task)
            self._first_admission(task)
        runner.encode(group, self._stats)
        now = time.perf_counter()
        for task in group:
            self._stats.record_slo(task)
            self.completed.append(task)
            self._stats.requests_completed += 1
            if self.tracer:
                self.tracer.request_span(
                    task.uid, "request", task._t_submit, now,
                    latency_ms=task.latency_ms,
                    prompt_len=task.prompt_len, encode=True)
        return len(group)

    # -- retirement ------------------------------------------------------
    def _retire(self, skip=()):
        """Release finished decode slots.  `skip` holds the slots of an
        uncommitted in-flight step (the overlapped loop): their output and
        pos lag a token, so they retire after its commit."""
        runner = self.runner
        for b, task in enumerate(runner.slots):
            if task is None or runner.prefilling[b] or b in skip:
                continue
            tok = task.output[-1]
            if (len(task.output) >= task.max_new_tokens
                    or (task.eos_id is not None and tok == task.eos_id)
                    or int(runner.pos[b]) >= runner.max_seq - 1):
                task.done = True
                now = time.perf_counter()
                task.latency_ms = (now - task._t_submit) * 1e3
                n = len(task.output)
                task.tpot_ms = ((task.latency_ms - task.ttft_ms) / (n - 1)
                                if n > 1 else 0.0)
                if n > 1:
                    self._stats.add_tpot_ms(task.tpot_ms)
                self._stats.record_slo(task)
                self.completed.append(task)
                self._stats.requests_completed += 1
                if self.tracer:
                    self.tracer.request_span(
                        task.uid, "request", task._t_submit, now,
                        ttft_ms=task.ttft_ms, tpot_ms=task.tpot_ms,
                        latency_ms=task.latency_ms, tokens=n,
                        prompt_len=task.prompt_len, degraded=task.degraded,
                        cached_prefix=task.cached_prefix)
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
        """One engine iteration: shed -> one encode batch -> admit ->
        retire -> chunk advance -> retire -> AR step -> retire.  Returns
        the TokenEvents produced (EncodeTasks carry their result in
        `.embedding`).  With overlap=True the AR step's token fetch moves
        into the next iteration (the same tokens)."""
        if not self.tracer:
            return self._step_inner()
        t0 = time.perf_counter()
        events = self._step_inner()
        self.tracer.step_span(
            "engine_step", t0, time.perf_counter(),
            queued=len(self.queue) + len(self.encode_queue),
            degrade=self._degrade,
            running=sum(s is not None for s in self.runner.slots),
            events=len(events))
        return events

    def _step_inner(self) -> List[TokenEvent]:
        self._shed_expired()
        self._degrade = self.scheduler.degrade_level(len(self.queue),
                                                     self.runner.B)
        if self.runner.spec is not None and self.runner.tree_branches > 1:
            # rung 1: backlogged tree rounds shrink to their chain for as
            # long as the pressure lasts (a round-scoped flag)
            self.runner._tree_chain_only = self._degrade >= 1
        if self.overlap:
            return self._step_overlapped()
        return self._step_sync()

    def _token_events(self, fresh: List) -> List[TokenEvent]:
        return [TokenEvent(task.uid, task.output[i],
                           task.done and i == len(task.output) - 1)
                for task, i in fresh]

    def _settle(self, fresh: List):
        """Admit and retire until the slots are full or the queue drains: a
        request finished by its prefill token alone frees its slot for
        another admission before the AR step.  A free slot the pool cannot
        serve yet is not progress."""
        runner = self.runner
        while True:
            n_done = len(self.completed)
            admitted = self._admit(fresh)
            self._retire()
            if not self.queue or not runner.free_slots():
                break
            if not admitted and len(self.completed) == n_done:
                break

    def _ensure_blocks(self):
        """Every decoding slot's next write block (and, speculating, the
        verify chunk's), evicting the policy's victims to the queue's
        head."""
        runner = self.runner
        victim = lambda running: self.scheduler.select_victim(
            running, time.perf_counter())
        # speculation needs the verify chunk's blocks up front: the
        # lookahead extends each slot's need to pos + its depth
        la = runner.spec_lookahead() if runner.spec else None
        for task in runner.ensure_decode_blocks(victim, self._stats,
                                                lookahead=la):
            self.queue.insert(0, task)

    def _note_stall(self):
        if self._t_last_decode is not None:
            # the time decoding slots sat idle since the last AR step:
            # admission work between decode steps (chunked prefill exists
            # to bound it)
            self._stats.add_decode_stall_ms(
                (time.perf_counter() - self._t_last_decode) * 1e3)

    def _step_sync(self) -> List[TokenEvent]:
        runner = self.runner
        fresh: List = []
        self._run_encode()
        self._settle(fresh)
        self._advance_chunks(fresh)
        self._retire()         # a last piece's token may end its request
        if runner.decoding_slots():
            self._ensure_blocks()
            if runner.decoding_slots():
                self._note_stall()
                fresh.extend(runner.spec_decode(self._stats) if runner.spec
                             else runner.decode(self._stats))
                self._t_last_decode = time.perf_counter()
                self._retire()
        if not runner.decoding_slots():
            self._t_last_decode = None    # idle gaps are not decode stalls
        return self._token_events(fresh)

    # -- the overlapped loop (overlap=True) -------------------------------
    def _pending_slots(self):
        return (frozenset(b for b, _ in self._pending.decoding)
                if self._pending is not None else frozenset())

    def _commit_pending(self, fresh: List):
        """Fetch the in-flight step's tokens.  Everything the engine did
        since its dispatch (encode, admission, chunk passes, even the next
        dispatch) ran while the device computed it: that host wall is the
        overlap (`host_overlap_ratio`)."""
        handle = self._pending
        self._pending = None
        self._stats.overlap_host_s += max(
            0.0, time.perf_counter() - handle.t0)
        self._stats.overlapped_steps += 1
        fresh.extend(self.runner.decode_commit(handle, self._stats))
        self._t_last_decode = time.perf_counter()

    def _fast_dispatch_ok(self) -> bool:
        """Whether the next decode step may be dispatched before the pending
        step's tokens are fetched: the pending commit provably changes no
        scheduling state (no retirement: no eos watch, the output budget
        and the sequence horizon not reached by the flying token) and every
        decoding slot owns its next write block alone (no allocation, no
        preemption, no copy on write).  Sampled rows need nothing more:
        each samples in the step keyed by (seed, position)."""
        runner = self.runner
        if (runner.spec is not None          # acceptance is data-dependent
                or not runner.decode_step.fn.chainable  # a host write came
                or self.queue or self.encode_queue      # admission may reseat
                or any(runner.prefilling)):  # a last chunk writes tokens
            return False
        pend = self._pending.decoding
        if not pend:
            return False
        for b, task in pend:
            if task.eos_id is not None:
                return False     # the flying token may be EOS
            if len(task.output) + 1 >= task.max_new_tokens:
                return False     # the commit reaches the output budget
            if int(runner.pos[b]) >= runner.max_seq - 1:
                return False     # the commit reaches the sequence horizon
            if not runner.next_token_block_ready(b):
                return False     # allocator or copy-on-write work first
        return True

    def _step_overlapped(self) -> List[TokenEvent]:
        runner = self.runner
        fresh: List = []
        if self._pending is not None and self._fast_dispatch_ok():
            # the steady state: dispatch step N + 1 chained on step N's
            # outputs on the device, THEN fetch N's tokens; no retirement
            # or admission is possible (_fast_dispatch_ok)
            nxt = runner.decode_dispatch()
            self.fast_dispatches += 1
            self._commit_pending(fresh)
            self._pending = nxt
            return self._token_events(fresh)
        # the regular path: every piece of host and non-decode device work
        # that cannot disturb the in-flight step runs before its fetch
        # (encode batches, admission prefills and chunk passes queue behind
        # it on the stream; its slots skip retirement until the commit)
        self._run_encode()
        pend = self._pending_slots()
        self._admit(fresh)
        self._retire(skip=pend)
        self._advance_chunks(fresh)
        if self._pending is not None:
            self._commit_pending(fresh)
        self._retire()
        # slots freed by retirement admit more work this step, as in the
        # synchronous loop
        self._settle(fresh)
        if runner.decoding_slots():
            self._ensure_blocks()
            if runner.decoding_slots():
                self._note_stall()
                if runner.spec:
                    # speculation never pipelines: a round's commit and
                    # rollback depend on how many proposals verify
                    fresh.extend(runner.spec_decode(self._stats))
                    self._t_last_decode = time.perf_counter()
                    self._retire()
                else:
                    self._pending = runner.decode_dispatch()
        if not runner.decoding_slots() and self._pending is None:
            self._t_last_decode = None
        return self._token_events(fresh)

    def has_work(self) -> bool:
        return (bool(self.queue) or bool(self.encode_queue)
                or self.runner.has_running() or self._pending is not None)

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
