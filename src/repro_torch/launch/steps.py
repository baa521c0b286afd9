"""Step builders and the decode-cache layout (port of the reference's
launch/steps.py, single device: no mesh, shard or plan arguments).

The reference jits each step; its decode step is one program with the
caches donated.  Here:

  make_decode_step   one AR step over static device buffers (token, pos,
                     block tables, sampling lane) and the runner's caches,
                     updated in place.  On a CUDA device it is captured once
                     in a CUDA graph after a warm-up on a side stream, and
                     each call copies the host inputs into the static
                     buffers and replays the graph; on the CPU the same body
                     runs eagerly.  Its launches depend on the shapes alone
                     (`lm.forward_decode`), so one graph serves every step.
  make_prefill_step  one NAR pass of a (bucket, group) batch, eager.
  make_encode_step   one pooled encode pass of a (bucket, group, pooling)
                     batch, eager.
  make_chunk_prefill_step
                     one chunked-prefill piece of C tokens a row into the
                     decode caches in place, eager (`chunk_support_reason`
                     says which configs can chunk).

`PagedLayout`, `make_paged_layout` and `cache_layout` give the paged
layout: block pools for full-context attention, dense ring caches for
window layers shorter than max_seq, per-slot SSM state.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import ATTN_KINDS, SSM_KINDS
from repro_torch.core import blocks
from repro_torch.core.nn import act_dtype
from repro_torch.kernels import ops
from repro_torch.models import lm

WARMUP_STEPS = 2    # eager decode steps before capture: builds the kernels,
                    # sets their shared-memory attributes, plans the GEMMs


@dataclass(frozen=True)
class PagedLayout:
    """Pools are [count, num_blocks + 1, block_size, KV, hd] per paged
    segment — the extra trailing block is the write sink for dropped
    writes; one [B, max_blocks] block table addresses every layer."""
    num_blocks: int
    block_size: int
    max_blocks: int                     # table width: ceil(max_seq / bs)
    segments: tuple                     # per-segment bool: k/v are pools

    @property
    def any_paged(self) -> bool:
        return any(self.segments)


def make_paged_layout(cfg, max_seq: int, num_blocks: int,
                      block_size: int) -> PagedLayout:
    return PagedLayout(
        num_blocks=num_blocks, block_size=block_size,
        max_blocks=-(-max_seq // block_size),
        segments=tuple(blocks.kind_paged(kind, cfg, max_seq)
                       for kind, _ in cfg.schedule))


def cache_layout(cfg, layout: PagedLayout, *, batch_size: int, policy,
                 device, kv_dtype=None):
    """Zeroed decode caches, one dict per segment: paged attention kinds
    get {"k", "v"} block pools; window layers shorter than max_seq get
    dense per-slot ring caches "k" / "v" [count, B, window, KV, hd]; both
    in the activation dtype.  `kv_dtype="int8"`: the pools are int8, with
    fp32 scales "ks" / "vs" [count, NB + 1, KV] (sink row included); ring
    caches keep the activation dtype, as the reference's dense layouts do.
    SSM kinds get per-slot dense state, "h" [count, B, Hp, P, N] fp32 and
    the conv tails "cx" [count, B, cw - 1, d_inner] / "cbc" [count, B,
    cw - 1, 2N] in the activation dtype."""
    if kv_dtype not in (None, "bfloat16", "int8"):
        raise ValueError(f"kv_dtype {kv_dtype!r} not in (None, 'bfloat16', "
                         f"'int8')")
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    Hp, P, N = cfg.padded_ssm_heads(), cfg.ssm_head_dim, cfg.ssm_state
    cw, dip = cfg.conv_width, cfg.padded_d_inner()
    ad = act_dtype(policy)
    B = batch_size
    out = []
    for (kind, count), paged in zip(cfg.schedule, layout.segments):
        d = {}
        if kind in ATTN_KINDS:
            rows = ((layout.num_blocks + 1, layout.block_size) if paged
                    else (B, blocks.kind_window(kind, cfg)))
            shape = (count, *rows, KV, hd)
            int8 = paged and kv_dtype == "int8"
            d["k"] = torch.zeros(shape, dtype=torch.int8 if int8 else ad,
                                 device=device)
            d["v"] = torch.zeros_like(d["k"])
            if int8:
                d["ks"] = torch.zeros((count, layout.num_blocks + 1, KV),
                                      dtype=torch.float32, device=device)
                d["vs"] = torch.zeros_like(d["ks"])
        if kind in SSM_KINDS:
            d["h"] = torch.zeros((count, B, Hp, P, N), dtype=torch.float32,
                                 device=device)
            d["cx"] = torch.zeros((count, B, cw - 1, dip), dtype=ad,
                                  device=device)
            d["cbc"] = torch.zeros((count, B, cw - 1, 2 * N), dtype=ad,
                                   device=device)
        out.append(d)
    return tuple(out)


# --------------------------------------------------------------------------
# bundles
# --------------------------------------------------------------------------

@dataclass
class StepBundle:
    fn: Callable                  # the step callable
    policy: Any
    cfg: Any
    aux: dict = field(default_factory=dict)


# --------------------------------------------------------------------------
# prefill and encode steps (NAR), eager
# --------------------------------------------------------------------------

def make_prefill_step(cfg, *, policy, max_seq: int, bucket: int, group: int,
                      compact_kv: bool = False,
                      fuse_epilogues: bool = True) -> StepBundle:
    """fn(params, tokens [group, bucket], lane) -> (next_token [group],
    caches, pos [group]): `lane` holds the rows' true lengths "prompt_len"
    and their sampling tensors (`serving.sampling.device_lane`), on the
    tokens' device; a lane of lengths alone decodes greedily.  Eager; the
    runner keeps one per (bucket, group)."""
    def fn(params, tokens, lane):
        if tuple(tokens.shape) != (group, bucket):
            raise ValueError(f"prefill step ({bucket}x{group}): tokens "
                             f"{tuple(tokens.shape)}")
        lane = dict(lane)
        prompt_len = lane.pop("prompt_len")
        return lm.forward_prefill(params, tokens, cfg=cfg, policy=policy,
                                  max_seq=max_seq, prompt_len=prompt_len,
                                  lane=lane or None, compact_kv=compact_kv,
                                  fused=fuse_epilogues)
    return StepBundle(fn=fn, policy=policy, cfg=cfg,
                      aux={"max_seq": max_seq, "bucket": bucket,
                           "group": group})


def make_encode_step(cfg, *, policy, bucket: int, group: int,
                     pooling: str = "last",
                     fuse_epilogues: bool = True) -> StepBundle:
    """fn(params, tokens [group, bucket], prompt_len [group]) -> pooled
    [group, d_model] float32 (`lm.forward_encode`).  Eager; the runner
    keeps one per (bucket, group, pooling)."""
    def fn(params, tokens, prompt_len):
        if tuple(tokens.shape) != (group, bucket):
            raise ValueError(f"encode step ({bucket}x{group}): tokens "
                             f"{tuple(tokens.shape)}")
        return lm.forward_encode(params, tokens, cfg=cfg, policy=policy,
                                 prompt_len=prompt_len, pooling=pooling,
                                 fused=fuse_epilogues)
    return StepBundle(fn=fn, policy=policy, cfg=cfg,
                      aux={"bucket": bucket, "group": group,
                           "pooling": pooling})


# --------------------------------------------------------------------------
# chunked-prefill step, eager
# --------------------------------------------------------------------------

def chunk_support_reason(cfg, layout: Optional[PagedLayout]) -> Optional[str]:
    """Why this (cfg, layout) cannot run the chunk stack, None when it can
    (the reference's reasons, word for word).  Chunked prefill and the
    prefix cache's suffix-only prefill both resume encoding at an
    arbitrary `pos0` against the paged decode caches, so both consult
    this one predicate."""
    if layout is None or not layout.any_paged or not all(layout.segments):
        return ("every KV segment must be block-paged (dense, ring, and SSM "
                "caches cannot carry resumable chunk state)")
    if cfg.has_ssm:
        return "recurrent SSM state absorbs chunk boundaries"
    if cfg.enc_schedule:
        return "cross-attention memory is not paged"
    if cfg.n_patches:
        return "patch prefixes occupy unpaged cache positions"
    if cfg.rope_theta <= 0:
        return "the chunk stack requires rotary positions"
    return None


def make_chunk_prefill_step(cfg, *, policy, layout: PagedLayout,
                            chunk_tokens: int,
                            fuse_epilogues: bool = True) -> StepBundle:
    """One chunked-prefill piece over the decode caches' layout:
    fn(params, tokens [n, C], pos0 [n], chunk_len [n], caches,
    tables [n, MB], lane) -> (token [n], caches, pos [n]), C =
    `chunk_tokens`, every operand on the caches' device; `lane` holds the
    rows' sampling tensors, or is None to decode greedily.  The caches
    are the runner's, written in place (the captured decode step holds
    their addresses): the returned caches are the same tensors.  The token
    is meaningful only for a row whose chunk completes its prompt (then it
    equals the whole-prompt prefill's sample).  `pos0` is any start: a
    chunk of a long prompt, or the uncached suffix of a prefix-cache hit.
    Eager; the runner keeps one per width, and `aux["calls"]` counts the
    passes run."""
    reason = chunk_support_reason(cfg, layout)
    if reason is not None:
        raise ValueError(f"chunked prefill unsupported for {cfg.name}: "
                         f"{reason}")
    aux = {"layout": layout, "chunk_tokens": chunk_tokens, "calls": 0}

    def fn(params, tokens, pos0, chunk_len, caches, tables, lane):
        if tokens.shape[1] != chunk_tokens:
            raise ValueError(f"chunk step ({chunk_tokens}): tokens "
                             f"{tuple(tokens.shape)}")
        aux["calls"] += 1
        return lm.forward_chunk(params, tokens, pos0, chunk_len, caches,
                                tables, cfg=cfg, policy=policy, lane=lane,
                                fused=fuse_epilogues,
                                paged_segments=layout.segments)
    return StepBundle(fn=fn, policy=policy, cfg=cfg, aux=aux)


# --------------------------------------------------------------------------
# decode step (AR), captured
# --------------------------------------------------------------------------

def _counts():
    return {name: (w.launches, dict(getattr(w, "launches_by", {})))
            for name, w in ops.launch_counters().items()}


class DecodeStep:
    """One AR step over static buffers.  The host inputs go to the device
    in one copy, into one int32 buffer whose views the step reads: token,
    pos, the lane's top_k, seed and temperature (fp32 bits) [B] each, and
    the block tables [B, MB].  The outputs are static too: next_token and
    pos + 1, [B] int32 each, overwritten by the next call."""

    def __init__(self, cfg, params, caches, *, policy, layout, batch_size,
                 fused, device):
        self.cfg, self.params, self.caches = cfg, params, caches
        self.policy, self.layout, self.fused = policy, layout, fused
        B, MB = batch_size, layout.max_blocks
        self.B = B
        n = 5 * B + B * MB
        self._host = torch.zeros(n, dtype=torch.int32)
        self._host_np = self._host.numpy()          # shares its memory
        self.inp = torch.zeros(n, dtype=torch.int32, device=device)
        self.token, self.pos = self.inp[:B], self.inp[B:2 * B]
        self.lane = {"top_k": self.inp[2 * B:3 * B],
                     "seed": self.inp[3 * B:4 * B],
                     "temperature": self.inp[4 * B:5 * B].view(torch.float32)}
        self.tables = self.inp[5 * B:].view(B, MB)
        self.out = torch.zeros((2, B), dtype=torch.int32, device=device)
        self.graph = None
        self.launches = {}      # wrapper -> (launches, by template) a replay
        self.replays = 0

    def load(self, token, pos, tables, lane):
        """Copy the host inputs into the static buffers (one copy: a later
        host mutation never reaches them)."""
        B, h = self.B, self._host_np
        h[:B] = token
        h[B:2 * B] = pos
        h[2 * B:3 * B] = lane["top_k"]
        h[3 * B:4 * B] = lane["seed"]         # int32, as the reference's
        h[4 * B:5 * B] = np.asarray(lane["temperature"],
                                    np.float32).view(np.int32)
        h[5 * B:] = np.asarray(tables).reshape(-1)
        self.inp.copy_(self._host)

    @torch.no_grad()
    def body(self):
        """The step on the static buffers: `lm.forward_decode` on the
        caches in place, next_token and pos + 1 into the outputs."""
        tok, _ = lm.forward_decode(
            self.params, self.token, self.pos, self.caches, cfg=self.cfg,
            policy=self.policy, block_tables=self.tables, lane=self.lane,
            fused=self.fused, paged_segments=self.layout.segments)
        self.out[0].copy_(tok)
        self.out[1].copy_(self.pos + 1)

    @torch.no_grad()
    def capture(self):
        """Warm up on a side stream, then capture one step in a CUDA graph
        (its own memory pool: the step's activations and kernel scratch)
        and record each wrapper's launches in it.  The capture launches
        nothing, so the wrappers' counters are set back after it.  A
        failed capture raises."""
        dev = self.inp.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                self.body()
        torch.cuda.current_stream(dev).wait_stream(side)
        before = _counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self.body()
        after = _counts()
        self.launches = {
            k: (after[k][0] - n, {t: after[k][1][t] - m
                                  for t, m in by.items()})
            for k, (n, by) in before.items()}
        for k, w in ops.launch_counters().items():
            w.launches = before[k][0]
            for t, m in before[k][1].items():
                w.launches_by[t] = m
        self.graph = graph

    def __call__(self, token, pos, tables, lane):
        """-> (next_token [B], pos + 1 [B], caches): the static outputs."""
        self.load(token, pos, tables, lane)
        if self.graph is None:
            self.body()
        else:
            self.graph.replay()
            self.replays += 1
            counters = ops.launch_counters()
            for k, (n, by) in self.launches.items():
                counters[k].launches += n
                for t, m in by.items():
                    counters[k].launches_by[t] += m
        return self.out[0], self.out[1], self.caches


def make_decode_step(cfg, params, caches, *, policy, layout: PagedLayout,
                     batch_size: int, fuse_epilogues: bool = True,
                     device) -> StepBundle:
    """The decode step over `caches` (`cache_layout`'s, holding nothing
    yet) and `params`, both kept for the step's life.  fn(token, pos,
    tables, lane) takes host arrays ([B], [B], [B, MB] and the lane's
    temperature / top_k / seed [B]) and returns (next_token, pos + 1,
    caches) as the reference's step does, sampling each row at step
    pos + 1.  On a CUDA device the step is captured here: the warm-up
    really runs (it writes the sink block, the ring caches and the SSM
    state), so the caches are zeroed after capture."""
    step = DecodeStep(cfg, params, caches, policy=policy, layout=layout,
                      batch_size=batch_size, fused=fuse_epilogues,
                      device=device)
    if step.inp.device.type == "cuda":
        step.capture()
        for seg in caches:
            for leaf in seg.values():
                leaf.zero_()
    return StepBundle(fn=step, policy=policy, cfg=cfg,
                      aux={"layout": layout,
                           "captured": step.graph is not None})
