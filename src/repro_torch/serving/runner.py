"""ModelRunner: policy-free model execution for the serving engine (port of
the reference's serving/runner.py).

Owns the device state — parameters, the paged KV pools, the per-slot ring
caches of window layers and SSM state, the block allocator and block
tables, the prefix cache, the sampling lanes and the per-slot token/pos
mirrors — and exposes four execution verbs:
`prefill(group)` (one batched NAR pass admitting a group into free slots),
`chunk_step(task)` (one chunked-prefill piece of a task parked in its
slot: `begin_chunked`, or a prefix-cache hit's suffix: `admit_cached`),
`decode()` (one AR step over every decoding slot; `spec_decode()` in its
place when speculation is on) and `encode(group)` (one pooled, cache-free
NAR pass for a batch of EncodeTasks; no slot, no block).  Scheduling
decisions live in the engine's policy.

`decode()` is `decode_commit(decode_dispatch())`: the overlapped engine
loop splits them and runs host scheduling work, or the next dispatch,
between a step's launch and its token fetch.  A dispatch advances the
host pos mirror at once (the step returns pos + 1 for every row) and, when
no host write to a row's token, pos, table or lane came between (the
decode step's `chainable`: `_unchain` clears it), takes its token and pos
from the previous step's outputs on the device instead of uploading them.
The fetch lands in a pinned buffer behind a CUDA event (`steps.TokenFetch`);
every pass runs on the current stream, so stream order keeps an admission
prefill's pool writes behind an in-flight step's reads.

`tracer=` (serving/trace.py) records the reference's spans and instants:
preempt, warm_hit, cow_copy, first_token; prefill, prefill_chunk,
decode_dispatch, decode_step, spec_draft, spec_verify and encode spans.
Every hook sits behind one `if self.tracer:` branch and observes only.

The steps come from `launch/steps.py`: the decode step is built (on a
card: captured in one CUDA graph) at construction, before any slot is
seated; prefill, chunk and encode steps are built per (bucket, group),
width and (bucket, group, pooling) at first use and kept.

Chunked prefill and the prefix cache (configs whose every KV segment is
paged and whose stack can resume at any position:
`steps.chunk_support_reason`).  A slot still prefilling is parked: it is
seated with its blocks, but its row of the decode tables stays -1 until
its last chunk lands, so the captured decode step, which runs every row,
writes that row's K/V to the sink block, and its sampled token is never
read.  The prefix cache (`serving/prefix_cache.py`) indexes the KV that
has landed; a warm admission shares the cached blocks and prefills only
the suffix, after copying a shared, partly filled tail block on write
(`kv_cache.block_copy`).  Every write to the caches — chunk scatter,
copy-on-write, int8 scale reset and scatter-max — happens in place: the
decode graph holds the pools' addresses.

Speculative decoding (`spec=SpecConfig(...)`, `serving/spec.py`): a draft
LM keeps a dense linear cache a slot (`steps.make_dense_layout`) and its
own decode step, captured like the target's (the tree form returns the
runners-up too); each round runs the draft's steps, then one eager verify
pass of the target over the chunk stack (`steps.make_verify_step` /
`make_tree_verify_step`), then the host's acceptance, commit and
rollback.  The draft prefills whole, in one pass, after each target
admission lands (`_draft_prefill`).

Int8 serving: `weight_dtype="int8"` quantizes the dense GEMM weights once,
at construction (`models/quantize.py`: one fp32 scale an output channel);
`kv_dtype="int8"` stores the paged KV pools in int8 with a scale a block
and kv head, quantized on write (admission and decode append).  Ring
caches, cross caches and SSM state keep the activation dtype.

An encoder-decoder (whisper-base) runs its encoder in every prefill and
encode pass over zero frame rows (`models/frontends.py:serving_frames`,
as the reference's runner passes them); no encoder output is kept across
passes.  Admission scatters each decoder layer's cross cache (ck / cv,
enc_seq_padded rows) into the slot's rows, and `kv_pool_bytes` counts it.
It cannot chunk, cache prefixes or speculate (`chunk_support_reason`,
`spec_support_reason`: the cross-attention memory is not paged).

Host mirrors (`tokens`, `pos`, `block_tables`, lanes) are numpy arrays that
the runner mutates; every transfer to the device copies (the decode step
copies them into its static buffers, the other steps take `torch.tensor`
copies), so a later mutation can never reach a tensor a step is still
reading.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import blocks
from repro_torch.core.precision import BF16
from repro_torch.device import resolve_device
from repro_torch.launch import steps as steps_mod
from repro_torch.models import lm
from repro_torch.models.frontends import serving_frames, serving_patches
from repro_torch.models.quantize import quantize_params
from repro_torch.serving.kv_cache import (BlockAllocator, block_copy,
                                          prefill_scatter, row_copy)
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.sampling import (device_lane, set_lane,
                                          stack_lanes, zero_lane)
from repro_torch.serving.spec import (DraftState, SpecConfig, accept_length,
                                      accept_tree_path, build_tree,
                                      resolve_draft, round_annotation,
                                      spec_support_reason, trim_emitted)
from repro_torch.serving.stats import EngineStats
from repro_torch.serving.tasks import EncodeTask, GenerateTask, Task


@dataclass
class DecodeHandle:
    """One in-flight AR step: its tokens on their way to the host and the
    host snapshot its commit needs.  `decode_dispatch` returns one,
    `decode_commit` consumes it; the overlapped engine loop holds at most
    one pending handle."""
    fetch: steps_mod.TokenFetch                 # the step's next tokens
    t0: float                                   # dispatch wall-clock
    decoding: List[Tuple[int, GenerateTask]]    # slots this step decoded
    live_tokens: int                            # post-step pos over decoding
    blocks_used: int                            # allocator.num_used then
    t_disp: float = 0.0                         # dispatch-return wall-clock
    #                                             (set only when tracing)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


class ModelRunner:
    """Parameters + paged caches + pool for one serving engine."""

    def __init__(self, cfg, params, *, batch_size: int = 4,
                 max_seq: int = 256, policy=None, min_bucket: int = 8,
                 block_size: int = 16, kv_pool_blocks: Optional[int] = None,
                 fuse_epilogues: bool = True, weight_dtype: str = "bfloat16",
                 kv_dtype: Optional[str] = None, prefix_cache: bool = False,
                 cache_blocks: Optional[int] = None,
                 spec: Optional[SpecConfig] = None, draft_params=None,
                 device=None, tracer=None):
        if min_bucket < 1:
            raise ValueError(f"min_bucket must be >= 1: {min_bucket}")
        if weight_dtype not in ("bfloat16", "int8"):
            raise ValueError(f"weight_dtype {weight_dtype!r} not in "
                             f"('bfloat16', 'int8')")
        if kv_dtype not in (None, "bfloat16", "int8"):
            raise ValueError(f"kv_dtype {kv_dtype!r} not in (None, "
                             f"'bfloat16', 'int8')")
        self.device = resolve_device(device)
        first = params["embedding"]["embed"]
        if first.device.type != self.device.type:
            raise ValueError(f"params live on {first.device}, the engine "
                             f"runs on {self.device}")
        self.cfg = cfg
        # opt-in structured tracer (serving/trace.py): every hook below is
        # behind one `if self.tracer:` branch and never feeds back
        self.tracer = tracer
        # the dense GEMM weights are quantized once, here; every step then
        # reads the int8 tensors and their scales
        self.weight_dtype = weight_dtype
        self._param_dtype = first.dtype
        if weight_dtype == "int8":
            params = quantize_params(params)
        self.params = params
        self.B = batch_size
        self.max_seq = max_seq
        self.min_bucket = min_bucket
        self.policy = policy or BF16
        self.fuse_epilogues = fuse_epilogues
        # pad-to-bucket is exact only for linear attention caches:
        # recurrent state (SSM, hybrid) would absorb pad positions and a
        # ring cache would roll pad rows in, so those configs prefill at
        # each prompt's exact length
        self._pad_buckets = not (cfg.has_ssm or cfg.sliding_window > 0)
        # encode has no cache: padding is exact whenever every kind is
        # causal (pads sit after the true positions and are never pooled);
        # a bidirectional kind attends its pads
        self._encode_pad = all(blocks.kind_causal(k, cfg)
                               for k, _ in cfg.schedule)
        # a VLM's patch prefix rides along in every prefill and encode
        # pass: it takes cache positions, shrinking a prompt's token budget
        self._n_prefix = cfg.n_patches or 0
        default_blocks = batch_size * (-(-max_seq // block_size))
        self.layout = steps_mod.make_paged_layout(
            cfg, max_seq, kv_pool_blocks or default_blocks, block_size)
        # int8 KV needs a block pool to hang its scales on: a config whose
        # every attention layer keeps a ring stays unquantized
        self.kv_dtype = ("int8" if kv_dtype == "int8"
                         and any(self.layout.segments) else "bfloat16")
        self.caches = steps_mod.cache_layout(
            cfg, self.layout, batch_size=batch_size, policy=self.policy,
            device=self.device, kv_dtype=self.kv_dtype)
        self.decode_step = steps_mod.make_decode_step(
            cfg, params, self.caches, policy=self.policy, layout=self.layout,
            batch_size=batch_size, fuse_epilogues=fuse_epilogues,
            device=self.device)
        self._prefill_steps: Dict[tuple, steps_mod.StepBundle] = {}
        self._encode_steps: Dict[tuple, steps_mod.StepBundle] = {}
        self._chunk_steps: Dict[int, steps_mod.StepBundle] = {}
        self.allocator = BlockAllocator(self.layout.num_blocks, block_size)
        # the chunk stack needs every segment's KV in the pool (the tables
        # are the chunk state); the prefix cache's suffix prefill is a
        # chunk at pos0 > 0, so it needs the same
        self.chunk_unsupported_reason = steps_mod.chunk_support_reason(
            cfg, self.layout)
        self.supports_chunked = self.chunk_unsupported_reason is None
        self.prefix_cache: Optional[PrefixCache] = None
        self.prefix_cache_reason: Optional[str] = None
        self.cow_copies = 0
        if prefix_cache:
            if self.supports_chunked:
                self.prefix_cache = PrefixCache(self.allocator, block_size,
                                                max_blocks=cache_blocks)
            else:
                self.prefix_cache_reason = self.chunk_unsupported_reason
        self.block_tables = np.full((batch_size, self.layout.max_blocks), -1,
                                    np.int32)
        self._slot_blocks: List[List[int]] = [[] for _ in range(batch_size)]
        self._admit_seq = 0
        self.tokens = np.zeros((batch_size,), np.int32)
        self.pos = np.zeros((batch_size,), np.int32)
        # the last decode commit's wall-clock: a pipelined step's elapsed
        # time is floored at it, so overlapped steps never count twice
        self._t_last_commit: Optional[float] = None
        self.lane = zero_lane(batch_size)
        self.slots: List[Optional[GenerateTask]] = [None] * batch_size
        # slots whose task is still chunk-prefilling: out of the decode
        # tables, their token / pos rows meaningless until the last chunk
        self.prefilling: List[bool] = [False] * batch_size
        # -- speculative decoding ------------------------------------------
        self.spec = spec
        self.draft_cfg = None
        self.tree_branches = 1
        # the degrade ladder's first rung (DeadlinePolicy under pressure):
        # token trees shrink to their chain while it is set
        self._tree_chain_only = False
        self.draft_states: List[Optional[DraftState]] = [None] * batch_size
        self.draft_decode_step = self.draft_topk_step = None
        self.verify_step = self.tree_verify_step = None
        if spec is not None:
            self._init_spec(spec, draft_params)

    def _init_spec(self, spec: SpecConfig, draft_params):
        """The draft LM (its params, dense linear caches and captured
        decode step) and the target's verify step (the reference's spec
        set-up)."""
        cfg = self.cfg
        reason = spec_support_reason(cfg)
        if reason is None and not self.supports_chunked:
            reason = ("engine layout cannot carry multi-token verify "
                      "state (paged KV cache with every segment paged "
                      "and dp == 1 required)")
        if reason is not None:
            raise ValueError(f"speculative decoding unsupported for "
                             f"{cfg.name}: {reason}")
        self.draft_cfg = resolve_draft(spec, cfg)
        # the draft stays bf16, being small, unless it IS the target, whose
        # params are quantized above
        if spec.draft == "self":
            self.draft_params = self.params
        elif draft_params is not None:
            self.draft_params = draft_params
        else:
            self.draft_params = lm.init_lm(self.draft_cfg,
                                           dtype=self._param_dtype,
                                           device=self.device,
                                           seed=spec.draft_seed)
        first = self.draft_params["embedding"]["embed"]
        if first.device.type != self.device.type:
            raise ValueError(f"draft params live on {first.device}, the "
                             f"engine runs on {self.device}")
        # token trees: the draft's top-b candidates a depth become sibling
        # leaves verified in one tree-masked pass.  int8 pools keep the
        # chain: the accepted path's compaction moves KV rows across
        # blocks, which a block's quantization scale cannot follow
        self.tree_branches = 1 if self.kv_dtype == "int8" else spec.branches
        self._round_depth: Optional[np.ndarray] = None
        self._round_width: Optional[np.ndarray] = None
        self.draft_layout = steps_mod.make_dense_layout(self.draft_cfg,
                                                        self.max_seq)
        self.draft_caches = steps_mod.cache_layout(
            self.draft_cfg, self.draft_layout, batch_size=self.B,
            policy=self.policy, device=self.device)
        kw = dict(policy=self.policy, batch_size=self.B,
                  fuse_epilogues=self.fuse_epilogues, device=self.device)
        if self.tree_branches > 1:
            self.draft_topk_step = steps_mod.make_draft_topk_step(
                self.draft_cfg, self.draft_params, self.draft_caches,
                branches=self.tree_branches, layout=self.draft_layout, **kw)
            self.tree_verify_step = steps_mod.make_tree_verify_step(
                cfg, layout=self.layout,
                num_tokens=1 + spec.k * self.tree_branches, **kw)
        else:
            self.draft_decode_step = steps_mod.make_decode_step(
                self.draft_cfg, self.draft_params, self.draft_caches,
                layout=self.draft_layout, **kw)
            self.verify_step = steps_mod.make_verify_step(
                cfg, layout=self.layout, num_tokens=spec.k + 1, **kw)
        self._draft_prefill_steps: Dict[tuple, steps_mod.StepBundle] = {}

    def weight_bytes_per_device(self) -> int:
        """Resident bytes of the parameters (int8 q leaves one byte an
        element, their fp32 scales beside them)."""
        return sum(t.numel() * t.element_size() for t in _leaves(self.params))

    def kv_pool_bytes(self) -> int:
        """Resident bytes of the decode caches: the paged pools with their
        scales, the ring caches, the cross caches and the SSM state (the
        sink blocks included)."""
        return sum(t.numel() * t.element_size() for t in _leaves(self.caches))

    # -- capacity / bucket geometry ------------------------------------
    @property
    def prompt_cap(self) -> int:
        """Longest admissible prompt (one decode position and the patch
        prefix reserved)."""
        return self.max_seq - 1 - self._n_prefix

    def bucket_for(self, prompt_len: int) -> int:
        """Smallest rung of {m, 1.5m} x 2^k >= max(min_bucket, len), capped
        at the token budget, max_seq less the patch prefix (8, 12, 16, 24,
        32, ... for min_bucket 8); the exact length for configs whose
        caches cannot absorb padding."""
        if not self._pad_buckets:
            return prompt_len
        return self._bucket(prompt_len)

    def encode_bucket_for(self, prompt_len: int) -> int:
        """Length bucket of an EncodeTask batch: the same rungs when every
        kind is causal (`_encode_pad`), else the exact length."""
        if not self._encode_pad:
            return prompt_len
        return self._bucket(prompt_len)

    def _bucket(self, prompt_len: int) -> int:
        cap = self.max_seq - self._n_prefix
        base = self.min_bucket
        while True:
            for cand in (base, base + base // 2):
                if cand >= prompt_len or cand >= cap:
                    return min(cand, cap)
            base *= 2

    # -- slot / pool bookkeeping ---------------------------------------
    def free_slots(self) -> List[int]:
        return [b for b in range(self.B) if self.slots[b] is None]

    def running(self) -> List[GenerateTask]:
        return [t for t in self.slots if t is not None]

    def has_running(self) -> bool:
        return any(s is not None for s in self.slots)

    def decoding_slots(self) -> List[int]:
        return [b for b in range(self.B)
                if self.slots[b] is not None and not self.prefilling[b]]

    def full_prompt(self, task: GenerateTask) -> np.ndarray:
        """What a (re-)prefill encodes: the prompt plus any tokens generated
        before a preemption."""
        if not task.output:
            return np.asarray(task.prompt, np.int32)
        return np.concatenate([np.asarray(task.prompt, np.int32),
                               np.asarray(task.output, np.int32)])

    def full_len(self, task: GenerateTask) -> int:
        return task.prompt_len + len(task.output)

    def blocks_needed(self, task: GenerateTask) -> int:
        return self.allocator.blocks_for(self._n_prefix + self.full_len(task))

    def alloc_for(self, task: GenerateTask) -> Optional[List[int]]:
        """All-or-nothing block allocation for (re-)admitting `task`."""
        return self.allocator.alloc(self.blocks_needed(task))

    def release_slot(self, b: int):
        if self._slot_blocks[b]:
            if self.prefix_cache is not None:
                self._index_slot(b)
            self.allocator.free(self._slot_blocks[b])
        self._slot_blocks[b] = []
        self.block_tables[b, :] = -1
        self._unchain()
        self.slots[b] = None
        self.prefilling[b] = False
        self.draft_states[b] = None

    def evict(self, b: int) -> GenerateTask:
        """Pull the task out of slot `b`, releasing its blocks (recompute
        preemption: the engine re-queues it; a chunked prefill restarts
        from scratch.  With the prefix cache on, the released blocks stay
        indexed, so the recompute is a warm admission while the pool keeps
        them)."""
        task = self.slots[b]
        if self.tracer:
            self.tracer.instant("preempt", time.perf_counter(), tid=task.uid,
                                recompute_tokens=self.full_len(task))
        self.release_slot(b)      # indexes [0, prefilled / pos) first
        task.prefilled = 0
        return task

    # -- prefix cache ------------------------------------------------------
    def cached_tokens_for(self, task: GenerateTask) -> int:
        """The cached-prefix length of `task` (no LRU touch, no hit-rate
        count): the scheduler's cache-aware admission probe."""
        if self.prefix_cache is None:
            return 0
        return self.prefix_cache.lookup(
            self.full_prompt(task), limit=self.full_len(task) - 1,
            touch=False, record=False)[1]

    def admit_cached(self, task: GenerateTask, b: int) -> Optional[bool]:
        """Warm admission: look up the longest cached prefix of the (re-)
        prefill sequence, share those blocks into slot `b`'s table and park
        the task prefilling with `prefilled = hit`, so only the suffix is
        encoded (`chunk_step` at pos0 = hit).  The hit is capped at
        full_len - 1: the last position is prefilled live for its logits.
        A hit ending inside a block copies that shared tail on write before
        the suffix overwrites its later positions.

        Returns None on a miss (the caller admits cold), False when the
        pool cannot supply the uncached blocks, True when seated."""
        pc = self.prefix_cache
        full = self.full_prompt(task)
        hit_blocks, hit = pc.lookup(full, limit=len(full) - 1)
        if hit <= 0:
            return None
        # pin the shared blocks before anything that could evict them
        self.allocator.retain(hit_blocks)
        bs = self.layout.block_size
        n_hit = len(hit_blocks)
        partial = hit % bs != 0
        need = self.blocks_needed(task) - n_hit + (1 if partial else 0)
        new = self.allocator.alloc(need)
        if new is None:
            self.allocator.free(hit_blocks)     # drop the pins
            return False
        table = list(hit_blocks)
        if partial:
            # the suffix writes positions [hit, ...) of a tail block other
            # holders depend on: duplicate it and take the private copy
            src, dst = table[n_hit - 1], new[0]
            block_copy(self.caches, src, dst, self.layout.segments)
            self.allocator.free([src])          # un-pin the shared original
            table[n_hit - 1] = dst
            new = new[1:]
            self.cow_copies += 1
        table.extend(new)
        self._seat(task, b, table)
        self.prefilling[b] = True
        task.prefilled = hit
        task.cached_prefix = hit
        if self.tracer:
            self.tracer.instant("warm_hit", time.perf_counter(),
                                tid=task.uid, cached_prefix=hit, cow=partial)
        return True

    def _index_slot(self, b: int):
        """Index slot `b`'s committed tokens before its blocks are
        released: KV covers [0, pos) for a slot that reached decode, the
        prefix landed so far for a slot still prefilling.  Newly indexed
        blocks gain an allocator reference and outlive the slot until the
        pool reclaims them."""
        task = self.slots[b]
        if task is None:
            return
        n_kv = task.prefilled if self.prefilling[b] else int(self.pos[b])
        if n_kv <= 0:
            return
        nb = self.allocator.blocks_for(n_kv)
        self.prefix_cache.insert(self.full_prompt(task)[:n_kv],
                                 self._slot_blocks[b][:nb])

    def _index_prompt_blocks(self, task: GenerateTask, blk: List[int]):
        """Index the full blocks of a freshly prefilled prompt the moment
        its KV lands.  Called after the first token joined `task.output`,
        so the landed KV covers full_len - 1 positions: the last token's KV
        is written by the next decode step, and a block straddling it is
        not published.  The partial tail joins the index at release."""
        if self.prefix_cache is None:
            return
        bs = self.layout.block_size
        n_full = ((self.full_len(task) - 1) // bs) * bs
        if n_full > 0:
            self.prefix_cache.insert(self.full_prompt(task)[:n_full],
                                     blk[:n_full // bs])

    # -- step caches -----------------------------------------------------
    def _prefill_for(self, bucket: int, group: int,
                     stats: EngineStats) -> steps_mod.StepBundle:
        step = self._prefill_steps.get((bucket, group))
        if step is None:
            step = steps_mod.make_prefill_step(
                self.cfg, policy=self.policy, max_seq=self.max_seq,
                bucket=bucket, group=group, compact_kv=True,
                fuse_epilogues=self.fuse_epilogues)
            self._prefill_steps[(bucket, group)] = step
            stats.prefill_compiles += 1
        return step

    def _chunk_for(self, width: int) -> steps_mod.StepBundle:
        step = self._chunk_steps.get(width)
        if step is None:
            step = steps_mod.make_chunk_prefill_step(
                self.cfg, policy=self.policy, layout=self.layout,
                chunk_tokens=width, fuse_epilogues=self.fuse_epilogues)
            self._chunk_steps[width] = step
        return step

    def _encode_for(self, bucket: int, group: int, pooling: str,
                    stats: EngineStats) -> steps_mod.StepBundle:
        step = self._encode_steps.get((bucket, group, pooling))
        if step is None:
            step = steps_mod.make_encode_step(
                self.cfg, policy=self.policy, bucket=bucket, group=group,
                pooling=pooling, fuse_epilogues=self.fuse_epilogues)
            self._encode_steps[(bucket, group, pooling)] = step
            stats.encode_compiles += 1
        return step

    def ensure_decode_blocks(
            self, select_victim: Callable[[Sequence[Task]], Task],
            stats: EngineStats,
            lookahead: Optional[np.ndarray] = None) -> List[GenerateTask]:
        """Before a decode step every decoding slot must own the block its
        next token lands in (pos // block_size), and, under speculation,
        the blocks the verify chunk's `lookahead[b]` further positions
        write (`spec_lookahead` caps each row so the need fits the pool);
        under prefix sharing it must own the first of them alone (a shared
        block is copied on write first).  Allocation failure evicts
        `select_victim(running)` until it succeeds; returns the evicted
        tasks (the engine re-queues them)."""
        evicted: List[GenerateTask] = []
        bs = self.layout.block_size
        for b in range(self.B):
            if self.slots[b] is None or self.prefilling[b]:
                continue
            la = int(lookahead[b]) if lookahead is not None else 0
            need = (int(self.pos[b]) + la) // bs + 1
            if need > self.allocator.num_blocks:
                raise RuntimeError(
                    f"KV pool too small: request {self.slots[b].uid} needs "
                    f"{need} blocks, pool capacity is "
                    f"{self.allocator.num_blocks}")
            while (self.slots[b] is not None
                   and len(self._slot_blocks[b]) < need):
                got = self.allocator.alloc(1)
                if got is not None:
                    self.block_tables[b, len(self._slot_blocks[b])] = got[0]
                    self._slot_blocks[b].extend(got)
                    self._unchain()
                    continue
                cand = self.running()
                if not cand:
                    raise RuntimeError("KV pool exhausted with no running "
                                       "request to preempt")
                victim = select_victim(cand)
                evicted.append(self.evict(self.slots.index(victim)))
                stats.preemptions += 1
            # the block the next token lands in must be private to this
            # slot; warm admission already copies the shared tail, so this
            # guards any other sharing path
            while (self.prefix_cache is not None
                   and self.slots[b] is not None):
                e = int(self.pos[b]) // bs
                blk = self._slot_blocks[b][e]
                if self.allocator.refcount(blk) <= 1:
                    break
                got = self.allocator.alloc(1)
                if got is not None:
                    block_copy(self.caches, blk, got[0],
                               self.layout.segments)
                    self._slot_blocks[b][e] = got[0]
                    self.block_tables[b, e] = got[0]
                    self._unchain()
                    self.allocator.free([blk])
                    self.cow_copies += 1
                    if self.tracer:
                        self.tracer.instant(
                            "cow_copy", time.perf_counter(),
                            tid=self.slots[b].uid, block=blk)
                    break
                cand = self.running()
                if not cand:
                    raise RuntimeError("KV pool exhausted with no running "
                                       "request to preempt")
                victim = select_victim(cand)
                evicted.append(self.evict(self.slots.index(victim)))
                stats.preemptions += 1
        return evicted

    def _unchain(self):
        """A host write to a row's token, pos, table or lane: the decode
        step's next inputs are uploaded (`DecodeStep.load`), not chained on
        its outputs."""
        self.decode_step.fn.chainable = False

    def _seat(self, task: GenerateTask, b: int, blk: List[int]):
        task._seq = self._admit_seq
        self._admit_seq += 1
        self.lane = set_lane(self.lane, b, task.sampling)
        self._unchain()
        self.slots[b] = task
        self.prefilling[b] = False
        self._slot_blocks[b] = list(blk)

    # -- execution -----------------------------------------------------
    @torch.no_grad()
    def prefill(self, group: List[Tuple[GenerateTask, List[int]]],
                free_slots: List[int], stats: EngineStats,
                ) -> List[Tuple[GenerateTask, int]]:
        """One batched NAR pass for an admission group (all in one length
        bucket), scattering its KV into the assigned blocks and its ring
        caches, cross caches and SSM state into its slots' rows.  Returns
        (task, output index) pairs for the freshly sampled first
        tokens."""
        tasks = [t for t, _ in group]
        fulls = [self.full_prompt(t) for t in tasks]
        bucket = self.bucket_for(len(fulls[0]))
        n = len(tasks)
        t0 = time.perf_counter()
        padded = np.zeros((n, bucket), np.int32)
        for j, seq in enumerate(fulls):
            padded[j, :len(seq)] = seq
        lane = {"prompt_len": np.asarray([len(f) for f in fulls], np.int64)}
        if any(not t.sampling.is_greedy for t in tasks):
            # an all-greedy group draws no noise: the eager step's
            # launches may follow the host's lane, the captured one's not
            lane.update(stack_lanes([t.sampling for t in tasks]))
        step = self._prefill_for(bucket, n, stats)
        tok, caches_g, pos_g = step.fn(
            self.params, torch.tensor(padded, device=self.device),
            device_lane(lane, self.device),
            serving_patches(self.cfg, n, device=self.device),
            serving_frames(self.cfg, n, device=self.device))
        slots = free_slots[:n]
        tables = np.full((n, self.layout.max_blocks), -1, np.int32)
        for j, (_, blk) in enumerate(group):
            tables[j, :len(blk)] = blk
        prefill_scatter(self.caches, caches_g,
                        torch.tensor(slots, device=self.device),
                        torch.tensor(tables, device=self.device),
                        block_size=self.layout.block_size,
                        paged_segments=self.layout.segments)
        tok_np = tok.cpu().numpy()                 # waits: honest timing
        self.tokens[slots] = tok_np
        self.pos[slots] = pos_g.cpu().numpy()
        self._unchain()
        now = time.perf_counter()
        dt_ms = (now - t0) * 1e3

        fresh: List[Tuple[GenerateTask, int]] = []
        n_first = 0
        for j, (task, blk) in enumerate(group):
            b = slots[j]
            first_admit = not task.output
            task.bucket = bucket
            task.prefill_ms += dt_ms / n
            task.prefilled = len(fulls[j])
            task.output.append(int(tok_np[j]))
            self._seat(task, b, blk)
            self.block_tables[b] = tables[j]
            self._index_prompt_blocks(task, blk)
            fresh.append((task, len(task.output) - 1))
            stats.bucket_hits[bucket] = stats.bucket_hits.get(bucket, 0) + 1
            if first_admit:
                n_first += 1
                task.ttft_ms = (now - task._t_submit) * 1e3
                stats.nar_tokens += task.prompt_len
                stats.padded_nar_tokens += bucket
                stats.add_ttft_ms(task.ttft_ms)
                if self.tracer:
                    self.tracer.instant("first_token", now, tid=task.uid,
                                        ttft_ms=task.ttft_ms)
            else:
                stats.recompute_tokens += len(fulls[j])
        stats.nar_time_s += (now - t0) * n_first / n
        stats.recompute_time_s += (now - t0) * (n - n_first) / n
        stats.prefill_batches += 1
        if self.tracer:
            self.tracer.step_span(
                "prefill", t0, now, phase="prefill", bucket=bucket, group=n,
                tokens=bucket * n, kv_positions=sum(len(f) for f in fulls),
                passes=1, busy_ms=(now - t0) * 1e3,
                uids=[t.uid for t in tasks])
        if self.spec is not None:
            self._draft_prefill(fulls, slots, stats)
        return fresh

    @torch.no_grad()
    def _draft_prefill(self, fulls: List[np.ndarray], slots: List[int],
                       stats: EngineStats):
        """The draft's cache rows for freshly (re-)admitted tasks: one
        batched draft prefill over the sequences the target encoded, in
        their length bucket, written into rows [0, bucket) of the slots'
        linear caches.  Pad rows past a sequence's length hold KV the
        draft never attends (its decode masks by pos) and overwrites as it
        advances.  The sampled token is discarded: the draft is only ever
        fed committed tokens."""
        n = len(fulls)
        bucket = self.bucket_for(max(len(f) for f in fulls))
        step = self._draft_prefill_steps.get((bucket, n))
        if step is None:
            step = steps_mod.make_prefill_step(
                self.draft_cfg, policy=self.policy, max_seq=self.max_seq,
                bucket=bucket, group=n, compact_kv=True,
                fuse_epilogues=self.fuse_epilogues)
            self._draft_prefill_steps[(bucket, n)] = step
        t0 = time.perf_counter()
        padded = np.zeros((n, bucket), np.int32)
        for j, seq in enumerate(fulls):
            padded[j, :len(seq)] = seq
        lens = np.asarray([len(f) for f in fulls], np.int64)
        _, dcaches, _ = step.fn(self.draft_params,
                                torch.tensor(padded, device=self.device),
                                device_lane({"prompt_len": lens},
                                            self.device))
        prefill_scatter(self.draft_caches, dcaches,
                        torch.tensor(slots, device=self.device), None,
                        block_size=1,
                        paged_segments=self.draft_layout.segments)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)    # honest timing
        for j, b in enumerate(slots):
            self.draft_states[b] = DraftState(pos=len(fulls[j]))
        stats.spec_draft_time_s += time.perf_counter() - t0

    # -- chunked prefill -------------------------------------------------
    def begin_chunked(self, task: GenerateTask, blk: List[int], b: int):
        """Park `task` in slot `b` with its full block allocation, in the
        prefilling state: its decode-table row stays -1 (the decode step
        writes that row to the sink) until the last chunk lands in
        `chunk_step`."""
        if not self.supports_chunked:
            raise ValueError(f"chunked prefill unsupported for "
                             f"{self.cfg.name}: "
                             f"{self.chunk_unsupported_reason}")
        self._seat(task, b, blk)
        self.prefilling[b] = True
        task.prefilled = 0

    @torch.no_grad()
    def chunk_step(self, task: GenerateTask, chunk_tokens: int,
                   stats: EngineStats) -> Optional[Tuple[GenerateTask, int]]:
        """Advance one piece of at most `chunk_tokens` prompt tokens for a
        parked `task` (one pass of width `chunk_tokens`, the tail padded).
        Returns the (task, output index) first-token event when this piece
        completes the prompt (the slot then joins decode), else None."""
        b = self.slots.index(task)
        if not self.prefilling[b]:
            raise RuntimeError(f"request {task.uid} is not prefilling")
        full = self.full_prompt(task)
        start = task.prefilled
        step = self._chunk_for(chunk_tokens)
        dev = self.device
        t0 = time.perf_counter()
        C = chunk_tokens
        take = min(C, len(full) - start)
        chunk = np.zeros((1, C), np.int32)
        chunk[0, :take] = full[start:start + take]
        row_table = np.full((1, self.layout.max_blocks), -1, np.int32)
        row_table[0, :len(self._slot_blocks[b])] = self._slot_blocks[b]
        # a greedy row draws no noise, as a greedy prefill group
        lane = (None if task.sampling.is_greedy else
                device_lane(stack_lanes([task.sampling]), dev))
        tok, _, pos_end = step.fn(
            self.params, torch.tensor(chunk, device=dev),
            torch.tensor([start], device=dev),
            torch.tensor([take], device=dev), self.caches,
            torch.tensor(row_table, device=dev), lane)
        tok_np = int(tok.cpu()[0])                 # waits: honest timing
        pos_np = int(pos_end.cpu()[0])
        now = time.perf_counter()
        task.prefilled = start + take
        task.prefill_ms += (now - t0) * 1e3
        first_admit = not task.output
        if first_admit:
            stats.nar_tokens += take
            stats.padded_nar_tokens += C
            stats.nar_time_s += now - t0
        else:
            stats.recompute_tokens += take
            stats.recompute_time_s += now - t0
        stats.prefill_chunks += 1
        stats.chunked_prefill_tokens += take
        if self.tracer:
            self.tracer.step_span(
                "prefill_chunk", t0, now, phase="prefill", uid=task.uid,
                tokens=C, true_tokens=take, kv_positions=take, passes=1,
                busy_ms=(now - t0) * 1e3, pos0=start,
                recompute=not first_admit)
        if task.prefilled < len(full):
            return None
        # the last piece: its token is the prompt's first output, and the
        # slot joins the decode batch
        task.bucket = -(-len(full) // chunk_tokens) * chunk_tokens
        task.output.append(tok_np)
        self.tokens[b] = tok_np
        self.pos[b] = pos_np
        self.prefilling[b] = False
        self.block_tables[b] = row_table[0]
        self._unchain()
        self._index_prompt_blocks(task, self._slot_blocks[b])
        if first_admit:
            task.ttft_ms = (now - task._t_submit) * 1e3
            stats.add_ttft_ms(task.ttft_ms)
            if self.tracer:
                self.tracer.instant("first_token", now, tid=task.uid,
                                    ttft_ms=task.ttft_ms)
        if self.spec is not None:
            # the draft, being small, prefills whole even when the target
            # chunked (or a warm admission prefilled only its suffix)
            self._draft_prefill([full], [b], stats)
        return (task, len(task.output) - 1)

    # -- decode ----------------------------------------------------------
    @torch.no_grad()
    def decode_dispatch(self) -> DecodeHandle:
        """Launch one lockstep AR step over every decoding slot (the
        captured step runs every row; a parked or free row writes to the
        sink) without waiting for its tokens.  The host pos mirror advances
        at once (the step returns pos + 1 for every row); the inputs are
        chained on the previous step's outputs when no host write came
        between (`DecodeStep.chainable`), else uploaded."""
        t0 = time.perf_counter()
        step = self.decode_step.fn
        decoding = [(b, self.slots[b]) for b in self.decoding_slots()]
        blocks_used = self.allocator.num_used
        fetch = step.dispatch(self.tokens, self.pos, self.block_tables,
                              self.lane, chained=step.chainable)
        self.pos += 1
        live = sum(int(self.pos[b]) for b, _ in decoding)
        handle = DecodeHandle(fetch, t0, decoding, live, blocks_used)
        if self.tracer:
            handle.t_disp = time.perf_counter()
            self.tracer.step_span(
                "decode_dispatch", t0, handle.t_disp, slots=len(decoding),
                uids=[t.uid for _, t in decoding])
        return handle

    def decode_commit(self, handle: DecodeHandle, stats: EngineStats,
                      ) -> List[Tuple[GenerateTask, int]]:
        """Wait for a dispatched step's tokens (its fetch's event) and
        commit them to the host mirrors, the tasks' outputs and the stats.
        The step's elapsed time is floored at the previous commit, so
        back-to-back pipelined steps do not count wall time twice.
        Returns the (task, output index) token events."""
        tr = self.tracer
        t_fetch = time.perf_counter() if tr else 0.0
        toks = handle.fetch.wait()                 # waits: honest timing
        now = time.perf_counter()
        floor = self._t_last_commit
        dt = now - (max(handle.t0, floor) if floor is not None
                    else handle.t0)
        self._t_last_commit = now
        fresh: List[Tuple[GenerateTask, int]] = []
        for b, task in handle.decoding:
            t = int(toks[b])
            if self.slots[b] is task:
                # the mirror catches up with the step's output: the chain
                # stays valid
                self.tokens[b] = t
            task.output.append(t)
            task.decode_ms += dt * 1e3
            fresh.append((task, len(task.output) - 1))
        stats.decode_steps += 1
        stats.ar_tokens += len(handle.decoding)
        stats.ar_time_s += dt
        stats.add_decode_step_ms(dt * 1e3)
        stats.occupied_slot_steps += len(handle.decoding)
        stats.block_slot_steps += handle.blocks_used
        stats.token_slot_steps += handle.live_tokens
        if tr:
            ann = {}
            if handle.t_disp:
                # host wall between the dispatch's return and the fetch:
                # scheduling work the device step hid
                ann["overlap_lag_ms"] = max(
                    0.0, (t_fetch - handle.t_disp) * 1e3)
            tr.step_span(
                "decode_step", handle.t0, now, phase="decode",
                slots=len(handle.decoding), tokens=len(handle.decoding),
                kv_positions=handle.live_tokens, passes=1, busy_ms=dt * 1e3,
                uids=[t.uid for _, t in handle.decoding], **ann)
        return fresh

    def decode(self, stats: EngineStats) -> List[Tuple[GenerateTask, int]]:
        """One lockstep AR step over every decoding slot, synchronous:
        dispatch, then commit at once.  Returns the (task, output index)
        token events."""
        return self.decode_commit(self.decode_dispatch(), stats)

    def next_token_block_ready(self, b: int) -> bool:
        """Whether decoding slot `b` can take one more decode step with no
        allocator or copy-on-write work: it owns the block pos[b] writes
        into, alone under prefix sharing.  The overlapped loop's
        dispatch-ahead fast path needs it (it runs before
        `ensure_decode_blocks` would)."""
        bs = self.layout.block_size
        need = int(self.pos[b]) // bs + 1
        if len(self._slot_blocks[b]) < need:
            return False
        if self.prefix_cache is not None:
            blk = self._slot_blocks[b][need - 1]
            if self.allocator.refcount(blk) > 1:
                return False
        return True

    # -- speculative decode (propose -> verify -> commit) ----------------
    def spec_lookahead(self) -> np.ndarray:
        """Per-slot speculation depth for the next round: `spec.k` capped so
        the verify chunk's writes stay inside the sequence horizon
        (committing past max_seq - 1 would emit tokens a step-by-step
        decode never reaches), inside the pool's capacity (so
        `ensure_decode_blocks` can always meet the lookahead, by
        preemption if need be), and inside the request's remaining
        max_new_tokens budget (a round commits at most that many; the cap
        cannot change outputs, each position's verify choice being
        independent of how many proposals follow it).

        Token trees (tree_branches > 1) reserve NODE capacity: a depth-d,
        width-w tree writes d * w node positions past pos.  Each row takes
        the deepest tree whose node count fits the same caps (at least
        depth 1), else the chain for the round; and when the trees'
        extra blocks together exceed the pool's FREE blocks, every row
        shrinks to its chain (sibling scratch never preempts a
        neighbour; the chain lookahead may, as at width 1).  The per-row
        (depth, width) lands in _round_depth / _round_width for the round
        that follows.

        The degrade ladder's rungs (DeadlinePolicy under pressure): a
        request admitted degraded proposes nothing (its rounds commit
        exactly the pending token: plain decode at verify-pass cost, still
        exact), and `_tree_chain_only` forces every row to its chain."""
        la = np.zeros((self.B,), np.int64)
        chain_la = np.zeros((self.B,), np.int64)
        cap_tokens = self.allocator.num_blocks * self.layout.block_size
        w = self.tree_branches
        depths = np.zeros((self.B,), np.int64)
        widths = np.ones((self.B,), np.int64)
        for b in self.decoding_slots():
            p = int(self.pos[b])
            task = self.slots[b]
            if task.degraded:
                continue
            room = task.max_new_tokens - len(task.output)
            la_c = max(0, min(self.spec.k, self.max_seq - 1 - p,
                              cap_tokens - 1 - p, room - 1))
            chain_la[b] = la_c
            if w > 1 and not self._tree_chain_only:
                la_t = min(la_c, (self.max_seq - 1 - p) // w,
                           (cap_tokens - 1 - p) // w)
                if la_t >= 1:
                    depths[b], widths[b], la[b] = la_t, w, la_t * w
                    continue
            depths[b], la[b] = la_c, la_c
        if w > 1 and bool(np.any(widths > 1)):
            bs = self.layout.block_size
            need = sum(
                max(0, (int(self.pos[b]) + int(la[b])) // bs + 1
                    - len(self._slot_blocks[b]))
                for b in self.decoding_slots())
            if need > self.allocator.num_free:
                for b in self.decoding_slots():
                    if widths[b] > 1:
                        depths[b], widths[b] = chain_la[b], 1
                        la[b] = chain_la[b]
        self._round_depth = depths
        self._round_width = widths
        return la

    def _token_at(self, task: GenerateTask, p: int) -> int:
        """The committed token at absolute position `p` (prompt, then the
        output history)."""
        if p < task.prompt_len:
            return int(task.prompt[p])
        return int(task.output[p - task.prompt_len])

    def _propose(self, active: List[int], pos0: np.ndarray,
                 depth: np.ndarray, width: Optional[np.ndarray],
                 stats: EngineStats):
        """The round's draft steps, lockstep over the batch.  The draft may
        lag the committed sequence (by one position after an all-accept
        round: the bonus token's predecessor never went through it), so
        each row first replays the committed tokens from its draft pos,
        then feeds its own proposals, `depth[b]` of them.  Each step is
        one replay of the draft's captured step.  Rows past their need
        (and free or parked rows) compute junk the round never reads; their
        position is clamped inside the linear cache.  -> (starts [B],
        steps run, {b: proposals}: chain tokens, or with `width` (the
        tree) the levels of top-`width[b]` candidates, the chain token
        first)."""
        starts = np.zeros((self.B,), np.int64)
        known: Dict[int, List[int]] = {}
        for b in active:
            ds = self.draft_states[b]
            starts[b] = ds.pos
            known[b] = [self._token_at(self.slots[b], p)
                        for p in range(ds.pos, int(pos0[b]) + 1)]
        n_steps = max(max(len(known[b]) - 1 + int(depth[b])
                          for b in active), 1)
        t0 = time.perf_counter()
        feed = np.zeros((self.B,), np.int32)
        props: Dict[int, list] = {b: [] for b in active}
        last = np.zeros((self.B,), np.int32)
        for s in range(n_steps):
            for b in active:
                feed[b] = known[b][s] if s < len(known[b]) else int(last[b])
            at = np.minimum(starts + s, self.max_seq - 1).astype(np.int32)
            if width is None:
                out, _, _ = self.draft_decode_step.fn(feed, at, None,
                                                      self.lane)
            else:
                out, alts, _, _ = self.draft_topk_step.fn(feed, at, None,
                                                          self.lane)
                alts = alts.cpu().numpy()
            last = out.cpu().numpy()
            for b in active:
                if (s >= len(known[b]) - 1
                        and len(props[b]) < int(depth[b])):
                    # alts[b, 0] is the chain token fed next step
                    props[b].append(int(last[b]) if width is None else
                                    [int(t) for t in alts[b, :int(width[b])]])
        t_draft = time.perf_counter() - t0
        stats.spec_draft_time_s += t_draft
        stats.add_draft_time_ms(t_draft * 1e3)
        if self.tracer:
            self.tracer.step_span(
                "spec_draft", t0, t0 + t_draft, phase="draft",
                steps=n_steps, slots=len(active), busy_ms=t_draft * 1e3)
        return starts, n_steps, props

    def _commit(self, b: int, task: GenerateTask, cand: List[int],
                pos0: int, dt: float, fresh: list) -> int:
        """Commit a round's candidates for slot `b` (trimmed to plain
        decode's retirement: the max_new / max_seq budget, cut at the
        first EOS), then roll back: blocks holding only rejected positions
        are freed and their table entries set to -1 (the garbage beyond
        pos in kept blocks is masked, then overwritten).  -> the new
        pos."""
        room = min(task.max_new_tokens - len(task.output),
                   self.max_seq - 1 - pos0)
        emitted = trim_emitted(cand, room=room, eos_id=task.eos_id)
        for tok in emitted:
            task.output.append(tok)
            fresh.append((task, len(task.output) - 1))
        pos_new = pos0 + len(emitted)
        self.tokens[b] = emitted[-1]
        self.pos[b] = pos_new
        self._unchain()
        task.decode_ms += dt * 1e3
        keep = self.allocator.blocks_for(pos_new)
        if len(self._slot_blocks[b]) > keep:
            extra = self._slot_blocks[b][keep:]
            del self._slot_blocks[b][keep:]
            self.allocator.free(extra)
            self.block_tables[b, keep:] = -1
        return pos_new

    def _round_stats(self, stats: EngineStats, occupied: int, emitted: int,
                     live_tokens: int, executed: int, dt: float):
        stats.decode_steps += 1
        stats.spec_rounds += 1
        stats.spec_slot_steps += occupied
        stats.spec_emitted_tokens += emitted
        stats.ar_tokens += emitted
        stats.ar_time_s += dt
        stats.add_decode_step_ms(dt * 1e3)
        stats.occupied_slot_steps += occupied
        stats.block_slot_steps += self.allocator.num_used
        stats.token_slot_steps += live_tokens
        stats.verify_positions += executed

    @torch.no_grad()
    def spec_decode(self, stats: EngineStats
                    ) -> List[Tuple[GenerateTask, int]]:
        """One speculative round over every decoding slot: the draft's
        proposal steps, ONE verify pass of the target (the round's whole
        target weight read), then host-side longest-prefix acceptance with
        rollback; the draft's pos rewinds with the target's.  Returns the
        committed (task, output index) events, 1 to k + 1 a slot: the
        target's own choices, as `decode()` run step by step would give
        them, greedy and sampled (`serving/spec.py`).  With
        tree_branches > 1 the round is the token-tree one
        (`_spec_decode_tree`)."""
        if self.tree_branches > 1:
            return self._spec_decode_tree(stats)
        active = self.decoding_slots()
        if not active:
            return []
        C = self.spec.k + 1
        la = self.spec_lookahead()
        pos0 = self.pos.astype(np.int64)
        starts, n_steps, proposals = self._propose(active, pos0, la, None,
                                                   stats)
        # -- verify: the target forwards [pending, d_1..d_ke] into the
        # slot's blocks and returns its own choice at every position
        chunk = np.zeros((self.B, C), np.int32)
        chunk_len = np.zeros((self.B,), np.int32)
        for b in active:
            chunk[b, 0] = self.tokens[b]
            chunk[b, 1:1 + len(proposals[b])] = proposals[b]
            chunk_len[b] = 1 + len(proposals[b])
        t1 = time.perf_counter()
        choices_d, _, _ = self.verify_step.fn(
            self.params, chunk, pos0, chunk_len, self.caches,
            self.block_tables, self.lane)
        choices = choices_d.cpu().numpy()          # waits: honest timing
        dt = time.perf_counter() - t1
        # -- commit + rollback
        fresh: List[Tuple[GenerateTask, int]] = []
        live_tokens = emitted = proposed = accepted = 0
        for b in active:
            task = self.slots[b]
            ke = len(proposals[b])
            cand = [int(c) for c in choices[b, :ke + 1]]
            j = accept_length(proposals[b], cand)
            proposed += ke
            accepted += j
            pos_new = self._commit(b, task, cand[:j + 1], int(pos0[b]), dt,
                                   fresh)
            emitted += pos_new - int(pos0[b])
            live_tokens += pos_new
            # the draft rewinds to the last position whose fed token is
            # committed (never past the committed horizon)
            self.draft_states[b].pos = min(int(starts[b]) + n_steps,
                                           int(pos0[b]) + j + 1, pos_new)
        stats.spec_proposed_tokens += proposed
        stats.spec_accepted_tokens += accepted
        self._round_stats(stats, len(active), emitted, live_tokens,
                          int(chunk_len.sum()), dt)
        if self.tracer:
            self.tracer.step_span(
                "spec_verify", t1, t1 + dt, phase="verify",
                tokens=int(chunk_len.sum()), kv_positions=live_tokens,
                passes=1, busy_ms=dt * 1e3, slots=len(active),
                **round_annotation(proposed=proposed, accepted=accepted,
                                   emitted=emitted))
        return fresh

    @torch.no_grad()
    def _spec_decode_tree(self, stats: EngineStats
                          ) -> List[Tuple[GenerateTask, int]]:
        """One token-tree round (tree_branches > 1).  Propose: the chain
        round's draft steps through the top-k step, whose runners-up give
        (b - 1) siblings a depth while the draft's cache advances along
        its chain only.  Verify: each slot's caterpillar tree
        (`spec.build_tree`) flattened into one [B, 1 + k * b] chunk, one
        tree-masked target pass (KV at pos0 + node index, rope and the
        sampling step at pos0 + depth, attention to each node's ancestors
        only).  Commit: the deepest root path whose nodes all match their
        parent's choice (`spec.accept_tree_path`); its KV rows move to the
        slot's committed positions pos0 + d (`kv_cache.row_copy`, bytes
        only), then the chain round's trim, rollback and draft rewind,
        the draft rewinding to the path's leading chain prefix (siblings
        never entered its cache).  The acceptance test is the chain's
        (seed, position)-keyed equality: outputs stay the target's own."""
        active = self.decoding_slots()
        if not active:
            return []
        C = 1 + self.spec.k * self.tree_branches
        if self._round_depth is None:
            self.spec_lookahead()
        depth_la, width = self._round_depth, self._round_width
        pos0 = self.pos.astype(np.int64)
        starts, n_steps, levels = self._propose(active, pos0, depth_la,
                                                width, stats)
        # -- verify: one tree-masked target pass over every slot's tree
        chunk = np.zeros((self.B, C), np.int32)
        chunk_len = np.zeros((self.B,), np.int32)
        depth_op = np.zeros((self.B, C), np.int32)
        anc_op = np.zeros((self.B, C, C), bool)
        trees = {}
        for b in active:
            tree = build_tree(int(self.tokens[b]), levels[b])
            trees[b] = tree
            n = tree.n_nodes
            chunk[b, :n] = tree.tokens
            depth_op[b, :n] = tree.depth
            anc_op[b, :n, :n] = tree.anc
            chunk_len[b] = n
        t1 = time.perf_counter()
        choices_d, _, _ = self.tree_verify_step.fn(
            self.params, chunk, pos0, chunk_len, depth_op, anc_op,
            self.caches, self.block_tables, self.lane)
        choices = choices_d.cpu().numpy()          # waits: honest timing
        dt = time.perf_counter() - t1
        # -- commit + compact + rollback
        fresh: List[Tuple[GenerateTask, int]] = []
        live_tokens = emitted = proposed = accepted = nodes = hits = 0
        depths = []
        bs = self.layout.block_size
        for b in active:
            task = self.slots[b]
            tree = trees[b]
            n = tree.n_nodes
            path = accept_tree_path(tree.tokens, tree.parent, choices[b], n)
            proposed += n - 1
            accepted += len(path)
            nodes += n
            stats.add_spec_path_depth(len(path))
            depths.append(len(path))
            if any(not tree.chain[i] for i in path):
                hits += 1
            full = [0] + path
            cand = [int(choices[b, i]) for i in full]
            # compact: committed position pos0 + d takes the KV node
            # full[d] wrote at pos0 + full[d] (roped at pos0 + d already);
            # full[] rises with full[d] >= d, so ascending moves never
            # clobber a pending source.  Only what is committed moves.
            room = min(task.max_new_tokens - len(task.output),
                       self.max_seq - 1 - int(pos0[b]))
            m = len(trim_emitted(cand, room=room, eos_id=task.eos_id))
            blks = self._slot_blocks[b]
            for d in range(1, m):
                if full[d] == d:
                    continue
                src, dst = int(pos0[b]) + full[d], int(pos0[b]) + d
                row_copy(self.caches, blks[src // bs], src % bs,
                         blks[dst // bs], dst % bs, self.layout.segments)
            pos_new = self._commit(b, task, cand, int(pos0[b]), dt, fresh)
            emitted += pos_new - int(pos0[b])
            live_tokens += pos_new
            # the draft's cache followed the CHAIN: it stays valid through
            # the path's leading chain prefix only
            j_chain = 0
            for i in path:
                if not tree.chain[i]:
                    break
                j_chain += 1
            self.draft_states[b].pos = min(int(starts[b]) + n_steps,
                                           int(pos0[b]) + j_chain + 1,
                                           pos_new)
        self._round_depth = self._round_width = None
        stats.spec_proposed_tokens += proposed
        stats.spec_accepted_tokens += accepted
        stats.spec_tree_nodes += nodes
        stats.spec_branch_hits += hits
        self._round_stats(stats, len(active), emitted, live_tokens,
                          int(chunk_len.sum()), dt)
        if self.tracer:
            self.tracer.step_span(
                "spec_verify", t1, t1 + dt, phase="verify",
                tokens=int(chunk_len.sum()), kv_positions=live_tokens,
                passes=1, busy_ms=dt * 1e3, slots=len(active),
                **round_annotation(proposed=proposed, accepted=accepted,
                                   emitted=emitted, tree_nodes=nodes,
                                   path_depths=depths, branch_hits=hits))
        return fresh

    @torch.no_grad()
    def encode(self, group: List[EncodeTask], stats: EngineStats):
        """One pooled full-sequence pass for a same-bucket, same-pooling
        batch of EncodeTasks; fills each task's `embedding` (read back to
        the host once a batch, so the timing is honest)."""
        if not group or len({t.pooling for t in group}) != 1:
            raise ValueError("an encode batch needs tasks of one pooling")
        n = len(group)
        lens = [t.prompt_len for t in group]
        bucket = self.encode_bucket_for(max(lens))
        step = self._encode_for(bucket, n, group[0].pooling, stats)
        t0 = time.perf_counter()
        padded = np.zeros((n, bucket), np.int32)
        for j, task in enumerate(group):
            padded[j, :task.prompt_len] = np.asarray(task.prompt, np.int32)
        pooled = step.fn(self.params,
                         torch.tensor(padded, device=self.device),
                         torch.tensor(lens, device=self.device),
                         serving_patches(self.cfg, n, device=self.device),
                         serving_frames(self.cfg, n, device=self.device))
        pooled_np = pooled.cpu().numpy()           # waits: honest timing
        now = time.perf_counter()
        dt = now - t0
        for j, task in enumerate(group):
            task.bucket = bucket
            task.embedding = pooled_np[j]
            task.encode_ms = dt * 1e3 / n
            task.latency_ms = (now - task._t_submit) * 1e3
            task.done = True
            stats.encode_tokens += task.prompt_len
            stats.padded_encode_tokens += bucket
            stats.add_encode_latency_ms(task.latency_ms)
            stats.bucket_hits[bucket] = stats.bucket_hits.get(bucket, 0) + 1
        stats.encode_time_s += dt
        stats.encode_batches += 1
        if self.tracer:
            self.tracer.step_span(
                "encode", t0, now, phase="encode", bucket=bucket, group=n,
                tokens=bucket * n, kv_positions=0, passes=1,
                busy_ms=dt * 1e3, uids=[t.uid for t in group])
