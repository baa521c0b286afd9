"""ModelRunner: policy-free model execution for the serving engine (port of
the reference's serving/runner.py, synchronous whole-prompt path).

Owns the device state — parameters, the paged KV pools, the per-slot ring
caches of window layers and SSM state, the block allocator and block
tables, the sampling lanes and the per-slot token/pos mirrors — and exposes
three execution verbs:
`prefill(group)` (one batched NAR pass admitting a group into free slots),
`decode()` (one AR step over every decoding slot) and `encode(group)` (one
pooled, cache-free NAR pass for a batch of EncodeTasks; no slot, no
block).  Scheduling decisions live in the engine's policy.

The steps come from `launch/steps.py`: the decode step is built (on a
card: captured in one CUDA graph) at construction, before any slot is
seated; prefill and encode steps are built per (bucket, group) and
(bucket, group, pooling) at first use and kept.

Int8 serving: `weight_dtype="int8"` quantizes the dense GEMM weights once,
at construction (`models/quantize.py`: one fp32 scale an output channel);
`kv_dtype="int8"` stores the paged KV pools in int8 with a scale a block
and kv head, quantized on write (admission and decode append).  Ring
caches and SSM state keep the activation dtype.

Host mirrors (`tokens`, `pos`, `block_tables`, lanes) are numpy arrays that
the runner mutates; every transfer to the device copies (the decode step
copies them into its static buffers, the other steps take `torch.tensor`
copies), so a later mutation can never reach a tensor a step is still
reading.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import blocks
from repro_torch.core.precision import BF16
from repro_torch.device import resolve_device
from repro_torch.launch import steps as steps_mod
from repro_torch.models.quantize import quantize_params
from repro_torch.serving.kv_cache import BlockAllocator, prefill_scatter
from repro_torch.serving.sampling import (device_lane, set_lane,
                                          stack_lanes, zero_lane)
from repro_torch.serving.stats import EngineStats
from repro_torch.serving.tasks import EncodeTask, GenerateTask, Task


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
                 kv_dtype: Optional[str] = None, device=None):
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
        # the dense GEMM weights are quantized once, here; every step then
        # reads the int8 tensors and their scales
        self.weight_dtype = weight_dtype
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
        self.allocator = BlockAllocator(self.layout.num_blocks, block_size)
        self.block_tables = np.full((batch_size, self.layout.max_blocks), -1,
                                    np.int32)
        self._slot_blocks: List[List[int]] = [[] for _ in range(batch_size)]
        self._admit_seq = 0
        self.tokens = np.zeros((batch_size,), np.int32)
        self.pos = np.zeros((batch_size,), np.int32)
        self.lane = zero_lane(batch_size)
        self.slots: List[Optional[GenerateTask]] = [None] * batch_size

    def weight_bytes_per_device(self) -> int:
        """Resident bytes of the parameters (int8 q leaves one byte an
        element, their fp32 scales beside them)."""
        return sum(t.numel() * t.element_size() for t in _leaves(self.params))

    def kv_pool_bytes(self) -> int:
        """Resident bytes of the decode caches: the paged pools with their
        scales, the ring caches and the SSM state (the sink blocks
        included)."""
        return sum(t.numel() * t.element_size() for t in _leaves(self.caches))

    # -- capacity / bucket geometry ------------------------------------
    @property
    def prompt_cap(self) -> int:
        """Longest admissible prompt (one decode position reserved)."""
        return self.max_seq - 1

    def bucket_for(self, prompt_len: int) -> int:
        """Smallest rung of {m, 1.5m} x 2^k >= max(min_bucket, len), capped
        at max_seq (8, 12, 16, 24, 32, ... for min_bucket 8); the exact
        length for configs whose caches cannot absorb padding."""
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
        cap = self.max_seq
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
        return [b for b in range(self.B) if self.slots[b] is not None]

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
        return self.allocator.blocks_for(self.full_len(task))

    def alloc_for(self, task: GenerateTask) -> Optional[List[int]]:
        """All-or-nothing block allocation for (re-)admitting `task`."""
        return self.allocator.alloc(self.blocks_needed(task))

    def release_slot(self, b: int):
        if self._slot_blocks[b]:
            self.allocator.free(self._slot_blocks[b])
        self._slot_blocks[b] = []
        self.block_tables[b, :] = -1
        self.slots[b] = None

    def evict(self, b: int) -> GenerateTask:
        """Pull the task out of slot `b`, releasing its blocks (recompute
        preemption: the engine re-queues it)."""
        task = self.slots[b]
        self.release_slot(b)
        task.prefilled = 0
        return task

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
            stats: EngineStats) -> List[GenerateTask]:
        """Before a decode step every decoding slot must own the block its
        next token lands in (pos // block_size).  Allocation failure evicts
        `select_victim(running)` until it succeeds; returns the evicted
        tasks (the engine re-queues them)."""
        evicted: List[GenerateTask] = []
        bs = self.layout.block_size
        for b in range(self.B):
            if self.slots[b] is None:
                continue
            need = int(self.pos[b]) // bs + 1
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
                    continue
                cand = self.running()
                if not cand:
                    raise RuntimeError("KV pool exhausted with no running "
                                       "request to preempt")
                victim = select_victim(cand)
                evicted.append(self.evict(self.slots.index(victim)))
                stats.preemptions += 1
        return evicted

    def _seat(self, task: GenerateTask, b: int, blk: List[int]):
        task._seq = self._admit_seq
        self._admit_seq += 1
        self.lane = set_lane(self.lane, b, task.sampling)
        self.slots[b] = task
        self._slot_blocks[b] = list(blk)

    # -- execution -----------------------------------------------------
    @torch.no_grad()
    def prefill(self, group: List[Tuple[GenerateTask, List[int]]],
                free_slots: List[int], stats: EngineStats,
                ) -> List[Tuple[GenerateTask, int]]:
        """One batched NAR pass for an admission group (all in one length
        bucket), scattering its KV into the assigned blocks and its ring
        caches and SSM state into its slots' rows.  Returns (task, output
        index) pairs for the freshly sampled first tokens."""
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
            device_lane(lane, self.device))
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
            fresh.append((task, len(task.output) - 1))
            stats.bucket_hits[bucket] = stats.bucket_hits.get(bucket, 0) + 1
            if first_admit:
                n_first += 1
                task.ttft_ms = (now - task._t_submit) * 1e3
                stats.nar_tokens += task.prompt_len
                stats.padded_nar_tokens += bucket
                stats.add_ttft_ms(task.ttft_ms)
            else:
                stats.recompute_tokens += len(fulls[j])
        stats.nar_time_s += (now - t0) * n_first / n
        stats.recompute_time_s += (now - t0) * (n - n_first) / n
        stats.prefill_batches += 1
        return fresh

    @torch.no_grad()
    def decode(self, stats: EngineStats) -> List[Tuple[GenerateTask, int]]:
        """One lockstep AR step over every decoding slot.  Returns the
        (task, output index) token events."""
        t0 = time.perf_counter()
        decoding = [(b, self.slots[b]) for b in self.decoding_slots()]
        tok, _, _ = self.decode_step.fn(self.tokens, self.pos,
                                        self.block_tables, self.lane)
        toks = tok.cpu().numpy()                   # waits: honest timing
        self.pos += 1
        now = time.perf_counter()
        dt = now - t0
        fresh: List[Tuple[GenerateTask, int]] = []
        for b, task in decoding:
            t = int(toks[b])
            self.tokens[b] = t
            task.output.append(t)
            task.decode_ms += dt * 1e3
            fresh.append((task, len(task.output) - 1))
        stats.decode_steps += 1
        stats.ar_tokens += len(decoding)
        stats.ar_time_s += dt
        stats.add_decode_step_ms(dt * 1e3)
        stats.occupied_slot_steps += len(decoding)
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
                         torch.tensor(lens, device=self.device))
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
