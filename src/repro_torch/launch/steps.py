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
                     `DecodeStep.dispatch` runs a step without waiting for
                     it, its input chained on the previous step's outputs
                     (one device-to-device copy) or loaded, its tokens
                     fetched into a pinned buffer behind an event.
  make_prefill_step  one NAR pass of a (bucket, group) batch, eager (a VLM
                     config's patch rows in front of the bucket; an
                     encoder-decoder's frame rows, which its encoder
                     reads first).
  make_encode_step   one pooled encode pass of a (bucket, group, pooling)
                     batch, eager (the same patch and frame rows).
  make_chunk_prefill_step
                     one chunked-prefill piece of C tokens a row into the
                     decode caches in place, eager (`chunk_support_reason`
                     says which configs can chunk).
  make_decode_step on the dense layout, and make_draft_topk_step
                     a speculative draft's decode step (the second with the
                     runners-up of its choice, `lm.forward_decode_topk`),
                     captured like the target's.
  make_verify_step, make_tree_verify_step
                     one speculative verify pass of C tokens (or tree
                     nodes) a row into the target's pools in place, eager;
                     the host operands reach the device as one copy of one
                     buffer, as the decode step's do.

`PagedLayout`, `make_paged_layout` and `cache_layout` give the paged
layout: block pools for full-context attention, dense ring caches for
window layers shorter than max_seq, per-slot SSM state, and per-slot dense
cross caches of an encoder-decoder's decoder layers (the captured decode
step reads them as static buffers).
`make_dense_layout` gives the reference's `paged=None` layout, a linear
cache of max_seq rows a slot for every full-context layer: a draft's.

  make_train_step    one training step on one device: the loss and the
                     gradients of the fp32 master params through the cast
                     to the policy's param dtype (`lm.forward_train`: the
                     hand kernels' autograd Functions on the card), global
                     norm clipping, the LR schedule at the state's step,
                     AdamW in place, step + 1.  Eager.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.configs.base import ATTN_KINDS, SSM_KINDS
from repro_torch.core import blocks
from repro_torch.core.nn import act_dtype
from repro_torch.core.precision import BF16
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import lm
from repro_torch.models.params import (meta_tree, tree_flatten, tree_map,
                                       tree_unflatten)
from repro_torch.optim import (adamw_init, adamw_update, clip_by_global_norm,
                               cosine_schedule)

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
    max_seq: int = 0                    # rows of a linear dense cache

    @property
    def any_paged(self) -> bool:
        return any(self.segments)


def make_paged_layout(cfg, max_seq: int, num_blocks: int,
                      block_size: int) -> PagedLayout:
    return PagedLayout(
        num_blocks=num_blocks, block_size=block_size,
        max_blocks=-(-max_seq // block_size),
        segments=tuple(blocks.kind_paged(kind, cfg, max_seq)
                       for kind, _ in cfg.schedule),
        max_seq=max_seq)


def make_dense_layout(cfg, max_seq: int) -> PagedLayout:
    """The reference's `paged=None` layout: no pool and no table (zero
    blocks, zero table entries); every attention layer keeps a dense cache
    a slot, linear [B, max_seq, KV, hd] for a full-context layer (a ring
    for a window shorter than max_seq).  A speculative draft's caches."""
    return PagedLayout(num_blocks=0, block_size=1, max_blocks=0,
                       segments=(False,) * len(cfg.schedule),
                       max_seq=max_seq)


def cache_layout(cfg, layout: PagedLayout, *, batch_size: int, policy,
                 device, kv_dtype=None):
    """Zeroed decode caches, one dict per segment: paged attention kinds
    get {"k", "v"} block pools; window layers shorter than max_seq get
    dense per-slot ring caches "k" / "v" [count, B, window, KV, hd], and
    full-context layers of the dense layout linear ones [count, B,
    max_seq, KV, hd]; all in the activation dtype.  `kv_dtype="int8"`:
    the pools are int8, with fp32 scales "ks" / "vs" [count, NB + 1, KV]
    (sink row included); dense caches keep the activation dtype, as the
    reference's dense layouts do.
    A `dec` segment (an encoder-decoder's decoder) gets per-slot dense
    cross caches "ck" / "cv" [count, B, enc_seq_padded, KV, hd] at the
    activation dtype under every layout and kv_dtype (the reference's
    dense_dtype: int8 KV quantizes the pools alone).
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
                    else (B, blocks.kind_cache_len(kind, cfg, layout.max_seq)
                          if layout.max_seq
                          else blocks.kind_window(kind, cfg)))
            shape = (count, *rows, KV, hd)
            int8 = paged and kv_dtype == "int8"
            d["k"] = torch.zeros(shape, dtype=torch.int8 if int8 else ad,
                                 device=device)
            d["v"] = torch.zeros_like(d["k"])
            if int8:
                d["ks"] = torch.zeros((count, layout.num_blocks + 1, KV),
                                      dtype=torch.float32, device=device)
                d["vs"] = torch.zeros_like(d["ks"])
        if kind == "dec":
            d["ck"] = torch.zeros((count, B, cfg.enc_seq_padded, KV, hd),
                                  dtype=ad, device=device)
            d["cv"] = torch.zeros_like(d["ck"])
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
    """fn(params, tokens [group, bucket], lane, patches=None,
    frames=None) -> (next_token [group], caches, pos [group]): `lane`
    holds the rows' true lengths "prompt_len" and their sampling tensors
    (`serving.sampling.device_lane`), on the tokens' device; a lane of
    lengths alone decodes greedily.  `patches` [group, n_patches,
    d_model]: a VLM config's patch rows (the runner's are zeros,
    `models/frontends.py:serving_patches`), in front of the bucket, so the
    pass runs bucket + n_patches positions.  `frames` [group,
    enc_seq_padded, d_model]: an encoder-decoder's frame rows (the
    runner's are zeros, `serving_frames`); the caches then hold the
    memory's ck / cv.  Eager; the runner keeps one per (bucket, group)."""
    def fn(params, tokens, lane, patches=None, frames=None):
        if tuple(tokens.shape) != (group, bucket):
            raise ValueError(f"prefill step ({bucket}x{group}): tokens "
                             f"{tuple(tokens.shape)}")
        lane = dict(lane)
        prompt_len = lane.pop("prompt_len")
        return lm.forward_prefill(params, tokens, cfg=cfg, policy=policy,
                                  max_seq=max_seq, prompt_len=prompt_len,
                                  lane=lane or None, compact_kv=compact_kv,
                                  fused=fuse_epilogues, patches=patches,
                                  frames=frames)
    return StepBundle(fn=fn, policy=policy, cfg=cfg,
                      aux={"max_seq": max_seq, "bucket": bucket,
                           "group": group})


def make_encode_step(cfg, *, policy, bucket: int, group: int,
                     pooling: str = "last",
                     fuse_epilogues: bool = True) -> StepBundle:
    """fn(params, tokens [group, bucket], prompt_len [group],
    patches=None, frames=None) -> pooled [group, d_model] float32
    (`lm.forward_encode`; `patches` and `frames` as in
    `make_prefill_step`).  Eager; the runner keeps one per (bucket, group,
    pooling)."""
    def fn(params, tokens, prompt_len, patches=None, frames=None):
        if tuple(tokens.shape) != (group, bucket):
            raise ValueError(f"encode step ({bucket}x{group}): tokens "
                             f"{tuple(tokens.shape)}")
        return lm.forward_encode(params, tokens, cfg=cfg, policy=policy,
                                 prompt_len=prompt_len, pooling=pooling,
                                 fused=fuse_epilogues, patches=patches,
                                 frames=frames)
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


class TokenFetch:
    """The next tokens of one dispatched decode step on their way to the
    host: on a card, a copy into a pinned host buffer enqueued right behind
    the step's replay and a CUDA event recorded behind the copy; on the
    CPU, the tokens themselves.  `wait()` blocks on that event alone and
    returns the tokens; it may be called once."""

    def __init__(self, buf: torch.Tensor, event=None):
        self.buf, self.event, self.done = buf, event, False

    def wait(self) -> np.ndarray:
        if self.done:
            raise RuntimeError("a token fetch is waited on once")
        if self.event is not None:
            self.event.synchronize()
        self.done = True
        return self.buf.numpy().copy()


class DecodeStep:
    """One AR step over static buffers.  The host inputs go to the device
    in one copy, into one int32 buffer whose views the step reads: token,
    pos, the lane's top_k, seed and temperature (fp32 bits) [B] each, and
    the block tables [B, MB].  The outputs are static too: next_token and
    pos + 1, [B] int32 each, overwritten by the next call.

    `dispatch` runs a step without waiting for it (the serving runner's
    overlapped loop).  Its input is either the host arrays (`load`) or,
    chained, the previous step's outputs: `out` ([2, B]: next token, then
    pos + 1) has the layout of the buffer's first 2B entries, so chaining
    is one device-to-device copy and uploads nothing; the tables and the
    lane stay as last loaded.  `chainable` says whether that is exact: a
    dispatch sets it, a `run` (whose inputs the caller's host arrays set)
    clears it, and so does the runner on every host write to a row's
    token, pos, table or lane."""

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
        # the token fetch's pinned host buffers, two alternating: step N + 1
        # is dispatched (its copy enqueued) before step N's tokens are read
        self._fetch_bufs = None
        if self.inp.device.type == "cuda":
            self._fetch_bufs = [torch.empty(B, dtype=torch.int32,
                                            pin_memory=True)
                                for _ in range(2)]
        self._fetches = [None, None]
        self.chainable = False
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
        if tables is not None:          # the dense layout has no table
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

    def replay(self):
        """Run the step on the buffers as they stand: replay the graph when
        there is one (adding the launches recorded at capture), else the
        body."""
        if self.graph is None:
            self.body()
            return
        self.graph.replay()
        self.replays += 1
        counters = ops.launch_counters()
        for k, (n, by) in self.launches.items():
            counters[k].launches += n
            for t, m in by.items():
                counters[k].launches_by[t] += m

    def run(self, token, pos, tables, lane):
        """Load the inputs and run the step."""
        self.load(token, pos, tables, lane)
        self.chainable = False
        self.replay()

    def chain(self):
        """The next step's token and pos are this step's outputs: one
        device-to-device copy, behind the step on the stream."""
        if not self.chainable:
            raise RuntimeError("the decode step's outputs are not its next "
                               "inputs (a host write or a run intervened)")
        self.inp[:2 * self.B].copy_(self.out.view(-1))

    @torch.no_grad()
    def dispatch(self, token, pos, tables, lane, *,
                 chained: bool = False) -> TokenFetch:
        """Run one step without waiting for it: chained (`chain`; the host
        arrays are not read) or loaded from the host arrays, then the
        next tokens' fetch enqueued behind the replay (`fetch`)."""
        if chained:
            self.chain()
        else:
            self.load(token, pos, tables, lane)
        self.replay()
        self.chainable = True
        return self.fetch()

    def fetch(self) -> TokenFetch:
        """Copy the next tokens to the host behind the step: into the
        pinned buffer whose last fetch was waited on, `non_blocking`, with
        an event recorded after the copy on the same stream (a failed
        event or copy raises).  On the CPU the step has run: its tokens."""
        if self._fetch_bufs is None:
            return TokenFetch(self.out[0].clone())
        i = next((i for i, f in enumerate(self._fetches)
                  if f is None or f.done), None)
        if i is None:
            raise RuntimeError("two decode steps' tokens are already in "
                               "flight")
        buf = self._fetch_bufs[i]
        buf.copy_(self.out[0], non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        self._fetches[i] = TokenFetch(buf, event)
        return self._fetches[i]

    def __call__(self, token, pos, tables, lane):
        """-> (next_token [B], pos + 1 [B], caches): the static outputs."""
        self.run(token, pos, tables, lane)
        return self.out[0], self.out[1], self.caches


class TopkDecodeStep(DecodeStep):
    """The tree draft's decode step: `DecodeStep` running
    `lm.forward_decode_topk`, with one more static output, alts [B, n]."""

    def __init__(self, *args, branches, **kw):
        super().__init__(*args, **kw)
        self.branches = branches
        self.alts = torch.zeros((self.B, branches), dtype=torch.int32,
                                device=self.inp.device)

    @torch.no_grad()
    def body(self):
        tok, alts, _ = lm.forward_decode_topk(
            self.params, self.token, self.pos, self.caches,
            n=self.branches, cfg=self.cfg, policy=self.policy,
            lane=self.lane, block_tables=self.tables, fused=self.fused,
            paged_segments=self.layout.segments)
        self.out[0].copy_(tok)
        self.out[1].copy_(self.pos + 1)
        self.alts.copy_(alts)

    def __call__(self, token, pos, tables, lane):
        """-> (next_token [B], alts [B, n], pos + 1 [B], caches)."""
        self.run(token, pos, tables, lane)
        return self.out[0], self.alts, self.out[1], self.caches


def _built(step, caches, cfg, policy, layout) -> StepBundle:
    if step.inp.device.type == "cuda":
        step.capture()
        for seg in caches:
            for leaf in seg.values():
                leaf.zero_()
    return StepBundle(fn=step, policy=policy, cfg=cfg,
                      aux={"layout": layout,
                           "captured": step.graph is not None})


def make_decode_step(cfg, params, caches, *, policy, layout: PagedLayout,
                     batch_size: int, fuse_epilogues: bool = True,
                     device) -> StepBundle:
    """The decode step over `caches` (`cache_layout`'s, holding nothing
    yet) and `params`, both kept for the step's life.  fn(token, pos,
    tables, lane) takes host arrays ([B], [B], [B, MB] and the lane's
    temperature / top_k / seed [B]) and returns (next_token, pos + 1,
    caches) as the reference's step does, sampling each row at step
    pos + 1.  On the dense layout (`make_dense_layout`: a draft's linear
    caches) there is no table and `tables` is None.  On a CUDA device the
    step is captured here: the warm-up really runs (it writes the sink
    block, the ring and linear caches and the SSM state), so the caches
    are zeroed after capture.  A failed capture raises."""
    step = DecodeStep(cfg, params, caches, policy=policy, layout=layout,
                      batch_size=batch_size, fused=fuse_epilogues,
                      device=device)
    return _built(step, caches, cfg, policy, layout)


def make_draft_topk_step(cfg, params, caches, *, branches: int, policy,
                         layout: PagedLayout, batch_size: int,
                         fuse_epilogues: bool = True,
                         device) -> StepBundle:
    """The tree draft's step: `make_decode_step`'s, returning also the
    runners-up of each row's choice.  fn(token, pos, tables, lane) ->
    (next_token [B], alts [B, branches], pos + 1 [B], caches), alts[:, 0]
    == next_token; captured on a CUDA device the same way."""
    step = TopkDecodeStep(cfg, params, caches, policy=policy, layout=layout,
                          batch_size=batch_size, fused=fuse_epilogues,
                          device=device, branches=branches)
    return _built(step, caches, cfg, policy, layout)


# --------------------------------------------------------------------------
# speculative verify steps, eager
# --------------------------------------------------------------------------

class VerifyStep:
    """One verify pass over the runner's caches.  Its host operands reach
    the device in one copy, into one int32 buffer whose views the pass
    reads: tokens [B, C], pos0 and chunk_len [B], the lane's top_k, seed
    and temperature (fp32 bits) [B], the block tables [B, MB], and for a
    tree its depth [B, C] and ancestor matrix [B, C, C] (0 / 1).  The
    pass is eager; nothing in it reads a device value back, so a CUDA
    graph could hold it with these operands unchanged."""

    def __init__(self, cfg, *, policy, layout, batch_size, num_tokens,
                 tree, fused, device, aux):
        reason = chunk_support_reason(cfg, layout)
        if reason is not None:
            raise ValueError(f"speculative verify unsupported for "
                             f"{cfg.name}: {reason}")
        self.cfg, self.policy, self.layout = cfg, policy, layout
        self.fused, self.tree, self.aux = fused, tree, aux
        B, C, MB = batch_size, num_tokens, layout.max_blocks
        self.B, self.C = B, C
        sizes = [("tokens", B * C), ("pos0", B), ("chunk_len", B),
                 ("top_k", B), ("seed", B), ("temperature", B),
                 ("tables", B * MB)]
        if tree:
            sizes += [("depth", B * C), ("anc", B * C * C)]
        n = sum(m for _, m in sizes)
        self._host = torch.zeros(n, dtype=torch.int32)
        self._host_np = self._host.numpy()
        self.inp = torch.zeros(n, dtype=torch.int32, device=device)
        self._at = {}
        at = 0
        for name, m in sizes:
            self._at[name] = (at, at + m)
            at += m
        v = {name: self.inp[a:b] for name, (a, b) in self._at.items()}
        self.tokens = v["tokens"].view(B, C)
        self.pos0, self.chunk_len = v["pos0"], v["chunk_len"]
        self.lane = {"top_k": v["top_k"], "seed": v["seed"],
                     "temperature": v["temperature"].view(torch.float32)}
        self.tables = v["tables"].view(B, MB)
        if tree:
            self.depth = v["depth"].view(B, C)
            self.anc = v["anc"].view(B, C, C)

    def _put(self, name, value, dtype=np.int32):
        a, b = self._at[name]
        self._host_np[a:b] = np.asarray(value, dtype).reshape(-1).view(
            np.int32)

    def load(self, tokens, pos0, chunk_len, tables, lane, depth=None,
             anc=None):
        """Copy the host operands into the buffer (one copy)."""
        self._put("tokens", tokens)
        self._put("pos0", pos0)
        self._put("chunk_len", chunk_len)
        self._put("top_k", lane["top_k"])
        self._put("seed", lane["seed"])
        self._put("temperature", lane["temperature"], np.float32)
        self._put("tables", tables)
        if self.tree:
            self._put("depth", depth)
            self._put("anc", anc)
        self.inp.copy_(self._host)

    @torch.no_grad()
    def __call__(self, params, tokens, pos0, chunk_len, *rest):
        if self.tree:
            depth, anc, caches, tables, lane = rest
        else:
            (caches, tables, lane), depth, anc = rest, None, None
        if np.shape(tokens) != (self.B, self.C):
            raise ValueError(f"verify step ({self.B}x{self.C}): tokens "
                             f"{np.shape(tokens)}")
        self.load(tokens, pos0, chunk_len, tables, lane, depth, anc)
        self.aux["calls"] += 1
        kw = dict(cfg=self.cfg, policy=self.policy, lane=self.lane,
                  fused=self.fused, paged_segments=self.layout.segments)
        if self.tree:
            return lm.forward_verify_tree(
                params, self.tokens, self.pos0, self.chunk_len, self.depth,
                self.anc != 0, caches, self.tables, **kw)
        return lm.forward_verify(params, self.tokens, self.pos0,
                                 self.chunk_len, caches, self.tables, **kw)


def _verify_bundle(cfg, *, policy, layout, batch_size, num_tokens, tree,
                   fuse_epilogues, device) -> StepBundle:
    aux = {"layout": layout, "num_tokens": num_tokens, "calls": 0}
    step = VerifyStep(cfg, policy=policy, layout=layout,
                      batch_size=batch_size, num_tokens=num_tokens,
                      tree=tree, fused=fuse_epilogues, device=device, aux=aux)
    return StepBundle(fn=step, policy=policy, cfg=cfg, aux=aux)


def make_verify_step(cfg, *, policy, layout: PagedLayout, batch_size: int,
                     num_tokens: int, fuse_epilogues: bool = True,
                     device) -> StepBundle:
    """The chain verify pass (`lm.forward_verify`), C = `num_tokens` = k +
    1: fn(params, tokens [B, C], pos0 [B], chunk_len [B], caches,
    tables [B, MB], lane) -> (choices [B, C], caches, pos [B]), every
    operand but params and caches a host array.  The caches are the
    runner's, written in place (the target's captured decode step holds
    their addresses).  Eager, one per engine; `aux["calls"]` counts the
    passes."""
    return _verify_bundle(cfg, policy=policy, layout=layout,
                          batch_size=batch_size, num_tokens=num_tokens,
                          tree=False, fuse_epilogues=fuse_epilogues,
                          device=device)


def make_tree_verify_step(cfg, *, policy, layout: PagedLayout,
                          batch_size: int, num_tokens: int,
                          fuse_epilogues: bool = True,
                          device) -> StepBundle:
    """The tree verify pass (`lm.forward_verify_tree`), C = `num_tokens` =
    1 + k * branches nodes: fn(params, tokens [B, C], pos0, chunk_len,
    depth [B, C], anc [B, C, C] bool, caches, tables, lane) -> (choices
    [B, C], caches, pos [B]); otherwise as `make_verify_step`."""
    return _verify_bundle(cfg, policy=policy, layout=layout,
                          batch_size=batch_size, num_tokens=num_tokens,
                          tree=True, fuse_epilogues=fuse_epilogues,
                          device=device)


# --------------------------------------------------------------------------
# train step
# --------------------------------------------------------------------------

TRAIN_RANGES = ("train_step.clip", "train_step.adamw")


def make_train_step(cfg, *, policy=None,
                    lr_fn: Optional[Callable] = None,
                    max_grad_norm: float = 1.0,
                    grad_compression: Optional[str] = None,
                    reduce_method: str = "ring",
                    ssm_seq_parallel: bool = False,
                    device=None) -> StepBundle:
    """fn(state, batch) -> (state, metrics), the reference's
    `make_train_step` on one device.  state: {"step" int32 scalar,
    "params" fp32 master tree, "opt": {"m", "v"}}, updated in place (the
    reference donates it) and returned with step + 1; batch: the data
    pipeline's dict.  The loss casts the master to `policy.param_dtype`
    (BF16 by default, the reference's train policy) inside the autograd
    graph, so the weight gradients come back through the cast; then they
    are clipped to `max_grad_norm` by global norm, the LR taken at the
    state's step (`lr_fn`, default cosine 3e-4 over 100 / 10,000 steps)
    and AdamW applied.  metrics: loss, ce, grad_norm, lr, tokens.  The
    clip and AdamW run under the `torch.profiler.record_function` ranges
    of `TRAIN_RANGES`, so a profiled step tells their device time apart
    from the forward and backward's.

    aux: "init_state"(seed) (random fp32 params, `lm.init_lm`, and zero
    moments on the device), "loss_and_grads"(params, batch) (the step's
    metrics and gradients alone), "state_from_numpy"(tree) (a reference
    state as numpy leaves), "state_like"() ("meta" tensors of the state,
    what `Checkpointer.restore` fills), "device".  The options of a mesh
    raise: one device."""
    if grad_compression:
        raise ValueError(f"grad_compression={grad_compression!r} compresses "
                         f"the cross-pod gradient reduction: it needs a pod "
                         f"mesh, and the port trains on one device")
    if reduce_method != "ring":
        raise ValueError(f"reduce_method={reduce_method!r} picks a "
                         f"collective schedule: the port trains on one "
                         f"device, with no collective")
    if ssm_seq_parallel:
        raise ValueError("ssm_seq_parallel shards an SSM scan over a "
                         "sequence mesh axis: the port trains on one device")
    policy = policy or BF16
    lr_fn = lr_fn or cosine_schedule(3e-4, 100, 10_000)
    dev = resolve_device(device)

    def loss_and_grads(params, batch):
        """-> (metrics, grads): the loss's metrics and the gradients of the
        fp32 `params` tree (a tree of the same structure)."""
        flat, tdef = tree_flatten(params)
        with torch.enable_grad():
            xs = [p.detach().requires_grad_(True) for p in flat]
            params_c = tree_unflatten(tdef, [
                x.to(policy.param_dtype) if x.is_floating_point() else x
                for x in xs])
            loss, metrics = lm.forward_train(params_c, batch, cfg=cfg,
                                             policy=policy)
            grads = torch.autograd.grad(loss, xs)
        return metrics, tree_unflatten(tdef, list(grads))

    def fn(state, batch):
        metrics, grads = loss_and_grads(state["params"], batch)
        with torch.no_grad():
            with record_function(TRAIN_RANGES[0]):
                clipped, gnorm = clip_by_global_norm(grads, None,
                                                     max_grad_norm)
            del grads
            with record_function(TRAIN_RANGES[1]):
                lr = torch.as_tensor(lr_fn(state["step"]),
                                     dtype=torch.float32, device=dev)
                params, opt = adamw_update(state["params"], clipped,
                                           state["opt"], step=state["step"],
                                           lr=lr)
        new_state = {"step": state["step"] + 1, "params": params, "opt": opt}
        metrics = dict(metrics, grad_norm=gnorm, lr=lr)
        return new_state, metrics

    def init_state(seed: int = 0):
        params = lm.init_lm(cfg, dtype=torch.float32, device=dev, seed=seed)
        return {"step": torch.zeros((), dtype=torch.int32, device=dev),
                "params": params, "opt": adamw_init(params)}

    def state_from_numpy(tree):
        def conv(t):
            return lm.params_from_numpy(t, cfg, dtype=torch.float32,
                                        device=dev)
        return {"step": torch.tensor(np.asarray(tree["step"]),
                                     dtype=torch.int32, device=dev),
                "params": conv(tree["params"]),
                "opt": {"m": conv(tree["opt"]["m"]),
                        "v": conv(tree["opt"]["v"])}}

    def state_like():
        p = meta_tree(lm.lm_param_shapes(cfg))
        return {"step": torch.empty((), dtype=torch.int32, device="meta"),
                "params": p,
                "opt": {"m": tree_map(torch.empty_like, p),
                        "v": tree_map(torch.empty_like, p)}}

    return StepBundle(fn=fn, policy=policy, cfg=cfg,
                      aux={"init_state": init_state,
                           "loss_and_grads": loss_and_grads,
                           "state_from_numpy": state_from_numpy,
                           "state_like": state_like, "device": dev})
