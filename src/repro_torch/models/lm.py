"""Decoder-only / encoder-decoder language model over the segment schedule
(port of the reference's models/lm.py serving path).

Parameters keep the reference's tree: `embedding/{embed, unemb}`,
`final_norm/{scale, bias}`, and one dict per schedule segment whose leaves
carry the layer dim first (`segments[i]/{ln1, ln2, attn/{wq, wk, wv, wo},
mlp/{w1 | wg, wu, w2}, moe/{wr, wg, wu, w2}, ssm/{w_x, w_z, w_bc, w_dt,
dt_bias, a_log, d_skip, conv_x, conv_bc, norm_scale, w_out}}`, each group
where the kind has it, and a `dec` layer's `lnx` / `xattn` too; the
experts stacked [L, NE, ., .]); an encoder-decoder (whisper) adds
`enc_segments` (one dict per encoder segment) and `enc_final_norm`.
The reference scans each segment with `lax.scan`; the port runs a Python
loop over its layers (`launch/steps.py` captures the decode step's launches
in one CUDA graph).

Modes: `forward_prefill` (NAR prompt pass, optional right-padding to a
length bucket — exact only without SSM state or ring caches — and compact
KV for paged admission; a VLM config's patch prefix, `models/frontends.py`,
occupies positions [0, n_patches) in front of the tokens), `forward_encode`
(the same stack with no cache, pooled to one fp32 vector a row) and
`forward_decode` (one AR step against the paged pools, the per-slot ring
caches of window layers and the per-slot SSM state, which it updates in
place) and `forward_chunk` (one
chunked-prefill piece written into the paged pools in place, from any
start position: a chunk of a long prompt, or the uncached suffix of a
prefix-cache hit).  Speculative decoding adds `forward_verify` and
`forward_verify_tree` (the target's choice at every position of a chunk of
proposals, on the chunk stack) and `forward_decode_topk` (the tree draft's
step: the decode step's choice and its runners-up).

An encoder-decoder (`cfg.enc_schedule`: whisper-base) runs its encoder in
every prefill and encode pass (`_run_encoder`: the stub frames
[B, enc_seq_padded, E] plus the sinusoidal table, the bidirectional `enc`
layers, `enc_final_norm`), and its `dec` layers read that memory: prefill
builds each layer's cross cache (ck / cv) from it, and a decode step
attends the cache's `enc_seq_padded` rows.  A config without rope
(rope_theta == 0) adds the sinusoidal table to its token embeddings at
their positions, in prefill and in every decode step, the table built once
a device (`_pos_table`) and indexed with the device positions, so that a
captured step reads a static buffer.
"""
from __future__ import annotations

import functools

import torch

from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LOCAL_KINDS, MOE_KINDS, SSM_KINDS
from repro_torch.core import blocks
from repro_torch.core.embedding import (ce_loss, embed_sequence, embed_token,
                                        embedding_param_shapes,
                                        greedy_token, init_embedding,
                                        sample_token, sample_topn)
from repro_torch.core.nn import act_dtype
from repro_torch.core.rope import sinusoidal_positions
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.params import layer, layers, tree_from_numpy


# --------------------------------------------------------------------------
# parameters
# --------------------------------------------------------------------------

def lm_param_shapes(cfg) -> dict:
    """The parameter tree's leaf shapes (segment leaves with the layer dim
    leading)."""
    def stack(tree, count):
        return {k: (stack(v, count) if isinstance(v, dict)
                    else (count,) + tuple(v)) for k, v in tree.items()}
    out = {
        "embedding": embedding_param_shapes(cfg),
        "final_norm": blocks.norm_shapes(cfg),
        "segments": tuple(stack(blocks.block_param_shapes(kind, cfg), count)
                          for kind, count in cfg.schedule),
    }
    if cfg.enc_schedule:
        out["enc_segments"] = tuple(
            stack(blocks.block_param_shapes(kind, cfg), count)
            for kind, count in cfg.enc_schedule)
        out["enc_final_norm"] = blocks.norm_shapes(cfg)
    return out


def init_lm(cfg, *, dtype=torch.bfloat16, device=None, seed: int = 0):
    """Random N(0, 0.02) weights (unit / zero norms) from a seeded
    `torch.Generator`, made on the device (the GPU unless device="cpu"):
    the decoder's segments, the embeddings, then an encoder-decoder's
    encoder segments."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    segs = tuple(blocks.init_block(gen, kind, cfg, dtype, dev, count)
                 for kind, count in cfg.schedule)
    out = {"embedding": init_embedding(gen, cfg, dtype, dev),
           "final_norm": blocks.init_norm(cfg, dtype, dev),
           "segments": segs}
    if cfg.enc_schedule:
        out["enc_segments"] = tuple(
            blocks.init_block(gen, kind, cfg, dtype, dev, count)
            for kind, count in cfg.enc_schedule)
        out["enc_final_norm"] = blocks.init_norm(cfg, dtype, dev)
    return out


def params_from_numpy(tree, cfg, *, dtype=torch.float32, device=None):
    """The reference's parameter tree (leaves as numpy arrays, e.g.
    `jax.tree.map(np.asarray, lm.init_lm(...))`) -> the port's parameters.
    bf16 leaves pass through float32, which is exact; the {"q", "scale"}
    leaves of a quantized tree (`quantize_params`) keep int8 q and fp32
    scales.  Raises on a missing leaf or a shape that does not match
    `cfg`."""
    return tree_from_numpy(tree, lm_param_shapes(cfg), dtype=dtype,
                           device=device)


# --------------------------------------------------------------------------
# segment runners
# --------------------------------------------------------------------------

def total_seq(cfg, s_text: int) -> int:
    """Positions of a sequence of `s_text` tokens behind the patch prefix."""
    return s_text + (cfg.n_patches or 0)


def _n_prefix(cfg, patches) -> int:
    """Patch positions in front of the tokens: a VLM config's n_patches,
    whose rows the caller must pass."""
    if cfg is None or not cfg.n_patches:
        return 0
    if patches is None or tuple(patches.shape[1:]) != (cfg.n_patches,
                                                       cfg.d_model):
        got = None if patches is None else tuple(patches.shape)
        raise ValueError(f"{cfg.name}: a pass behind a patch prefix needs "
                         f"its patch rows [B, {cfg.n_patches}, "
                         f"{cfg.d_model}], got {got}")
    return cfg.n_patches


@functools.lru_cache(maxsize=8)
def _table(n: int, d: int, device: torch.device):
    return sinusoidal_positions(n, d, device=device)


def _pos_table(cfg, device, rows: int = 0):
    """The sinusoidal table [n, d_model] fp32 of a config without rope, n
    the largest of cfg.max_seq, the encoder's frames and `rows`, built once
    a (size, device) and kept.  Row p does not depend on n: the
    reference's decode step indexes a table of cfg.max_seq rows, its
    prefill and its encoder tables of their own lengths, and those are the
    first rows of this one."""
    n = max(cfg.max_seq, cfg.enc_seq_padded, rows)
    return _table(n, cfg.d_model, torch.device(device))


def _positions_at(cfg, pos, dtype):
    """A decode step's table rows at `pos` ([B] device ints, clipped to
    cfg.max_seq - 1 as the reference clips), cast to `dtype`."""
    tab = _pos_table(cfg, pos.device)
    return tab[torch.clamp(pos.long(), 0, cfg.max_seq - 1)].to(dtype)


def _embed_sequence(params, tokens, *, policy, cfg=None, patches=None):
    """The residual stream [B, n_p + S, E]: the tokens behind a dummy id 0
    at each of the n_p patch positions of a VLM `cfg`, whose rows the
    patches then replace, plus the sinusoidal table at every position for
    a config without rope (the reference's `_embed_sequence`)."""
    n_p = _n_prefix(cfg, patches)
    if n_p:
        tokens = torch.cat([torch.zeros((tokens.shape[0], n_p),
                                        dtype=tokens.dtype,
                                        device=tokens.device), tokens], 1)
    x = embed_sequence(params["embedding"]["embed"], tokens, policy=policy)
    if n_p:
        x = torch.cat([patches.to(x.dtype), x[:, n_p:]], 1)
    if cfg is not None and cfg.rope_theta == 0:
        S = x.shape[1]
        x = x + _pos_table(cfg, x.device, S)[:S].to(x.dtype)[None]
    return x


def _check_frames(cfg, frames):
    """An encoder-decoder pass needs its frame rows [B, enc_seq_padded,
    d_model] (the stub frontend's output)."""
    want = (cfg.enc_seq_padded, cfg.d_model)
    if frames is None or frames.ndim != 3 or tuple(frames.shape[1:]) != want:
        got = None if frames is None else tuple(frames.shape)
        raise ValueError(f"{cfg.name}: an encoder-decoder pass needs its "
                         f"frames [B, {want[0]}, {want[1]}], got {got}")


def _run_encoder(params, frames, *, cfg, policy, fused=True):
    """The encoder over stub frame embeddings (the reference's
    `_run_encoder`): frames [B, enc_seq_padded, E] plus the sinusoidal
    table at the activation dtype, every `enc` layer (bidirectional, no
    cache), then `enc_final_norm` -> the memory [B, enc_seq_padded, E]."""
    _check_frames(cfg, frames)
    S = frames.shape[1]
    x = (frames + _pos_table(cfg, frames.device)[:S][None]).to(
        act_dtype(policy))
    for (kind, count), p_seg in zip(cfg.enc_schedule, params["enc_segments"]):
        for i in range(count):
            x, _ = blocks.block_full(kind, layer(p_seg, i), x, cfg=cfg,
                                     policy=policy, fused=fused)
    return ops.norm(x, params["enc_final_norm"], cfg.norm)


def _memory(params, frames, *, cfg, policy, fused):
    """The encoder's memory of an encoder-decoder pass (None for a config
    without an encoder schedule, whose `frames` must be None)."""
    if not cfg.enc_schedule:
        if frames is not None:
            raise ValueError(f"{cfg.name}: frames given to a config without "
                             f"an encoder")
        return None
    return _run_encoder(params, frames, cfg=cfg, policy=policy, fused=fused)


def _run_segments_prefill(params, x, *, cfg, policy, max_seq, fused=True,
                          compact_kv=False, with_cache=True, memory=None):
    """-> (x [B, S, E], caches): one dict per segment of stacked leaves —
    k / v [count, B, S_cache, KV, hd] at the activation dtype for attention
    kinds (ring layers: S_cache = window, in slot order), the SSM state
    h [count, B, Hp, P, N] and conv tails cx / cbc [count, B, cw - 1, .]
    for SSM kinds, and a `dec` segment's cross caches ck / cv [count, B,
    Sm, KV, hd] of the encoder's `memory` [B, Sm, E].  `with_cache=False`
    runs the same stack and builds no cache (the encode pass); caches is
    then None."""
    caches = []
    for (kind, count), p_seg in zip(cfg.schedule, params["segments"]):
        layers = []
        for i in range(count):
            x, cache = blocks.block_full(kind, layer(p_seg, i), x, cfg=cfg,
                                         policy=policy, fused=fused,
                                         with_cache=with_cache,
                                         max_seq=max_seq,
                                         compact_kv=compact_kv,
                                         memory=memory)
            layers.append(cache)
        if with_cache:
            caches.append({k: torch.stack([c[k] for c in layers])
                           for k in layers[0]})
    return x, (tuple(caches) if with_cache else None)


def _train_layer(x, kind, p, cfg, policy, memory, mode):
    with ops.kernel_mode(mode):
        return blocks.block_full(kind, p, x, cfg=cfg, policy=policy,
                                 memory=memory)[0]


def _run_segments_train(params, x, *, cfg, policy, memory=None):
    """Every layer of the schedule, each under `torch.utils.checkpoint`
    (non-reentrant): its activations are recomputed in the backward pass,
    kernel launches included, as the reference remats its scan body.  The
    recompute runs in the kernel mode of the forward (it is an argument:
    the mode is thread-local, and the backward of CUDA tensors runs on
    autograd's device thread).  The layers' parameters are `unbind` views
    of the stacked segments."""
    mode = ops.get_mode()
    for (kind, count), p_seg in zip(cfg.schedule, params["segments"]):
        for p in layers(p_seg, count):
            x = checkpoint(_train_layer, x, kind, p, cfg, policy, memory,
                           mode, use_reentrant=False)
    return x


def _run_segments_decode(params, x, pos, caches, *, cfg, policy,
                         block_tables, fused=True, paged_segments=None):
    """Every layer's decode step; pool, ring-cache and SSM-state leaves are
    updated in place (a `dec` layer's cross caches are read: every row
    attends the memory's enc_seq_padded rows).  `paged_segments`: per
    segment, whether its k / v are block pools (the layout's `segments`);
    None: every segment's are."""
    paged_segments = paged_segments or (True,) * len(cfg.schedule)
    memory_len = cfg.enc_seq_padded if cfg.enc_schedule else 0
    for (kind, count), p_seg, c_seg, paged in zip(
            cfg.schedule, params["segments"], caches, paged_segments):
        for i in range(count):
            x, _ = blocks.block_decode(kind, layer(p_seg, i), x, pos,
                                       layer(c_seg, i), cfg=cfg,
                                       policy=policy,
                                       block_tables=block_tables,
                                       fused=fused, paged=paged,
                                       memory_len=memory_len)
    return x, caches


def _embed_step(params, token, pos, *, cfg, policy):
    """A decode step's residual rows [B, E]: the tokens' embeddings, plus
    the sinusoidal table's rows at `pos` for a config without rope."""
    x = embed_token(params["embedding"]["embed"], token, policy=policy)
    if cfg.rope_theta == 0:
        x = x + _positions_at(cfg, pos, x.dtype)
    return x


def _run_chunk_stack(params, tokens, pos0, chunk_len, caches, block_tables,
                     *, cfg, policy, fused=True, paged_segments=None,
                     rope_pos=None, tree_mask=None):
    """The chunk body: embed C consecutive tokens a row, run every layer's
    `block_chunk` (KV written into the pools in place), then the final
    norm unless the fused head folds it.  Chunked prefill
    (`forward_chunk`: sample the last position), speculative verify
    (`forward_verify`: sample every position) and tree verify
    (`forward_verify_tree`: the `rope_pos` / `tree_mask` overrides) all
    sit on it; the verify passes' exactness rests on sharing one body.
    -> (x [B, C, E], caches, head_norm or None)."""
    B, C = tokens.shape
    x = embed_token(params["embedding"]["embed"], tokens.reshape(B * C),
                    policy=policy).reshape(B, C, -1)
    paged_segments = paged_segments or (True,) * len(cfg.schedule)
    for (kind, count), p_seg, c_seg, paged in zip(
            cfg.schedule, params["segments"], caches, paged_segments):
        if not paged:
            raise ValueError(f"chunk forward requires paged segments: "
                             f"{kind}")
        for i in range(count):
            x, _ = blocks.block_chunk(kind, layer(p_seg, i), x, pos0,
                                      chunk_len, layer(c_seg, i),
                                      block_tables, cfg=cfg, policy=policy,
                                      fused=fused, rope_pos=rope_pos,
                                      tree_mask=tree_mask)
    head_norm = _head_norm(params, cfg, fused)
    if head_norm is None:
        x = ops.norm(x, params["final_norm"], cfg.norm)
    return x, caches, head_norm


def _head_norm(params, cfg, fused: bool):
    """Final-norm prologue for the fused logits head (None: the unfused
    chain applies ops.norm first)."""
    if not fused:
        return None
    return ops.norm_prologue(params["final_norm"], cfg.norm)


def _residual_at(x, idx):
    """x: [B, S, E]; idx: [B] positions -> [B, E]."""
    rows = torch.arange(x.shape[0], device=x.device)
    return x[rows, idx.long()]


def _lengths(tokens, prompt_len):
    """[B] int64 true lengths on the tokens' device: `prompt_len` (host
    array or tensor), or every row's full length S."""
    B, S = tokens.shape
    if prompt_len is None:
        return torch.full((B,), S, dtype=torch.int64, device=tokens.device)
    return torch.as_tensor(prompt_len, device=tokens.device).to(torch.int64)


def _choose(x, params, lane, step, *, cfg, policy, norm):
    unemb = params["embedding"]["unemb"]
    if lane is None:
        return greedy_token(x, unemb, cfg=cfg, policy=policy, norm=norm)
    return sample_token(x, unemb, dict(lane, step=step), cfg=cfg,
                        policy=policy, norm=norm)


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------

def forward_prefill(params, tokens, *, cfg, policy, max_seq: int,
                    prompt_len=None, lane=None, compact_kv: bool = False,
                    fused: bool = True, patches=None, frames=None):
    """NAR prompt pass.  tokens: [B, S] -> (next_token [B], caches, pos [B]).

    `prompt_len` ([B] ints, a host array or a tensor on the tokens' device,
    optional): true lengths of rows right-padded to a length bucket; the
    next token is read at each row's last true position.  `lane` (per-row
    sampling tensors on the tokens' device, see
    core.embedding._lane_scores, without "step": the sampled token's
    position is each row's length): greedy when None.  `patches` [B,
    n_patches, d_model]: a VLM config's patch rows, at positions [0, n_p)
    in front of the tokens, so the caches hold n_p + S positions and pos
    = n_p + prompt_len (the decode position that follows).  `frames` [B,
    enc_seq_padded, d_model]: an encoder-decoder's frame rows, which the
    encoder reads first; each `dec` segment's caches then hold the
    memory's K / V too (ck / cv)."""
    n_p = _n_prefix(cfg, patches)
    memory = _memory(params, frames, cfg=cfg, policy=policy, fused=fused)
    x = _embed_sequence(params, tokens, cfg=cfg, policy=policy,
                        patches=patches)
    x, caches = _run_segments_prefill(params, x, cfg=cfg, policy=policy,
                                      max_seq=max_seq, fused=fused,
                                      compact_kv=compact_kv, memory=memory)
    head_norm = _head_norm(params, cfg, fused)
    if head_norm is None:
        x = ops.norm(x, params["final_norm"], cfg.norm)
    pos = n_p + _lengths(tokens, prompt_len)
    x_last = _residual_at(x, pos - 1)
    tok = _choose(x_last, params, lane, pos, cfg=cfg, policy=policy,
                  norm=head_norm)
    return tok, caches, pos.to(torch.int32)


def train_support_reason(cfg):
    """Why `forward_train` refuses `cfg` (None: it trains it): a block kind
    or a norm whose kernel has no gradient in the port yet."""
    kinds = {k for k, _ in cfg.schedule + tuple(cfg.enc_schedule or ())}
    if kinds & set(SSM_KINDS):
        return "the SSD scan (rows 11-12) has no gradient in the port yet"
    if kinds & set(MOE_KINDS):
        return ("the SwiGLU GEMM's expert form (row 2) and the MoE aux "
                "loss have no gradient in the port yet")
    if cfg.mlp_act == "swiglu":
        return "SwiGLU GEMM (row 2) has no gradient in the port yet"
    if kinds & set(LOCAL_KINDS):
        return ("flash attention with a window (row 3) has no gradient in "
                "the port yet")
    if cfg.norm == "rmsnorm":
        return "RMSNorm (row 7) has no gradient in the port yet"
    return None


def forward_train(params, batch, *, cfg, policy):
    """The train pass -> (loss_for_grad, {"ce", "tokens", "loss"}).

    `batch`: "tokens" / "labels" [B, S] (int), optional "valid" [B, S]
    bool, a VLM's "patches" and an encoder-decoder's "frames" as the data
    pipeline emits them.  The mean cross-entropy over the valid positions
    (patch positions never count) is both the loss to differentiate and
    the metrics' "ce" and "loss" (one device: no share of a mesh; no MoE
    aux loss for the kinds the port trains).  The fused chain, as the
    reference's train plan fuses its epilogues.  Refuses a config whose
    kernels have no gradient yet (`train_support_reason`), on both
    devices."""
    reason = train_support_reason(cfg)
    if reason is not None:
        raise NotImplementedError(f"forward_train: {cfg.name}: {reason}")
    tokens = batch["tokens"]
    patches = batch.get("patches")
    n_p = _n_prefix(cfg, patches)
    memory = _memory(params, batch.get("frames"), cfg=cfg, policy=policy,
                     fused=True)
    x = _embed_sequence(params, tokens, cfg=cfg, policy=policy,
                        patches=patches)
    labels = batch["labels"]
    valid = torch.ones(tokens.shape, dtype=torch.bool, device=tokens.device)
    if "valid" in batch:
        valid = valid & batch["valid"].bool()
    if n_p:
        B = tokens.shape[0]
        labels = torch.cat([torch.zeros((B, n_p), dtype=labels.dtype,
                                        device=labels.device), labels], 1)
        valid = torch.cat([torch.zeros((B, n_p), dtype=torch.bool,
                                       device=valid.device), valid], 1)
    x = _run_segments_train(params, x, cfg=cfg, policy=policy,
                            memory=memory)
    x = ops.norm(x, params["final_norm"], cfg.norm)
    loss_sum, cnt = ce_loss(x, params["embedding"]["unemb"], labels, valid,
                            cfg=cfg, policy=policy)
    n = torch.clamp(cnt, min=1.0)
    loss = loss_sum / n
    ce = loss.detach()
    return loss, {"ce": ce, "tokens": n, "loss": ce}


def forward_encode(params, tokens, *, cfg, policy, prompt_len=None,
                   pooling: str = "last", fused: bool = True, patches=None,
                   frames=None):
    """Encoder-only NAR pass: one full-sequence forward, no KV cache, no
    sampling.  tokens: [B, S] -> pooled [B, E] float32.

    `prompt_len` ([B] ints, host or device, optional): true lengths of
    rows right-padded to a length bucket.  Padding is output-exact only for
    causal schedules (a bidirectional kind attends its pads); the runner
    pads only when every kind is causal.
    `pooling`: "last" — the normalized residual at the last true position
    (what a prefill samples from); "mean" — the masked fp32 mean of the
    normalized rows over the true positions.  Fused "last" selects the raw
    row and normalizes only that row (the norm is row-wise); mean pooling
    normalizes every row first (the norm of a mean is not the mean of the
    norms).  `patches`: a VLM config's patch rows in front of the tokens
    (as in `forward_prefill`); the last position is n_p + prompt_len - 1
    and the mean covers the text positions alone.  `frames`: an
    encoder-decoder's frame rows (as in `forward_prefill`): the encoder
    runs first, and the decoder's layers attend its output."""
    if pooling not in ("last", "mean"):
        raise ValueError(f"pooling must be 'last' or 'mean': {pooling!r}")
    n_p = _n_prefix(cfg, patches)
    memory = _memory(params, frames, cfg=cfg, policy=policy, fused=fused)
    x = _embed_sequence(params, tokens, cfg=cfg, policy=policy,
                        patches=patches)
    x, _ = _run_segments_prefill(params, x, cfg=cfg, policy=policy,
                                 max_seq=0, fused=fused, with_cache=False,
                                 memory=memory)
    fused_head = fused and pooling == "last"
    if not fused_head:
        x = ops.norm(x, params["final_norm"], cfg.norm)
    pos = n_p + _lengths(tokens, prompt_len)
    if pooling == "last":
        row = _residual_at(x, pos - 1)
        if fused_head:
            row = ops.norm(row, params["final_norm"], cfg.norm)
        return row.float()
    at = torch.arange(x.shape[1], device=x.device)[None, :]
    keep = (at >= n_p) & (at < pos[:, None])
    s = (x.float() * keep[..., None]).sum(1)
    return s / (pos - n_p).clamp(min=1).float()[:, None]


def forward_decode(params, token, pos, caches, *, cfg, policy,
                   block_tables, lane=None, fused: bool = True,
                   paged_segments=None):
    """One AR step.  token, pos: [B] device tensors; block_tables [B, MB]
    -> (next_token [B], caches).  `lane` (per-row sampling tensors on the
    device, without "step": a sampled token's step is pos + 1, the position
    it will occupy, as the reference's): greedy when None.
    `paged_segments`: per segment, pools or ring caches (the layout's
    `segments`; None: pools everywhere).  No host value reaches the device
    and every launch depends on the shapes alone: `launch/steps.py`
    captures this function in a CUDA graph.  A config without rope adds
    the sinusoidal table's row at each pos; an encoder-decoder's `dec`
    layers attend their cross caches."""
    x = _embed_step(params, token, pos, cfg=cfg, policy=policy)
    x, caches = _run_segments_decode(params, x, pos, caches, cfg=cfg,
                                     policy=policy, block_tables=block_tables,
                                     fused=fused,
                                     paged_segments=paged_segments)
    head_norm = _head_norm(params, cfg, fused)
    if head_norm is None:
        x = ops.norm(x, params["final_norm"], cfg.norm)
    tok = _choose(x, params, lane, pos + 1, cfg=cfg, policy=policy,
                  norm=head_norm)
    return tok, caches


def forward_chunk(params, tokens, pos0, chunk_len, caches, block_tables, *,
                  cfg, policy, lane=None, fused: bool = True,
                  paged_segments=None):
    """One chunked-prefill piece: C consecutive prompt tokens a row into
    the paged pools, in place.  tokens: [B, C]; pos0: [B] absolute start
    position; chunk_len: [B] real tokens (<= C; the tail is padding); all
    device tensors.  -> (next_token [B], caches, pos [B] = pos0 +
    chunk_len).

    Every call samples a token at each row's last real position, at step
    pos0 + chunk_len; the caller uses it only when the chunk completes the
    prompt, where it is what `forward_prefill` samples (same residual, same
    (seed, step) draw).  Every segment must be paged
    (`launch/steps.py:chunk_support_reason`); `lane` as in forward_prefill,
    greedy when None."""
    B, C = tokens.shape
    x, caches, head_norm = _run_chunk_stack(
        params, tokens, pos0, chunk_len, caches, block_tables, cfg=cfg,
        policy=policy, fused=fused, paged_segments=paged_segments)
    n = chunk_len.to(torch.int64)
    pos = pos0.to(torch.int64) + n
    x_last = _residual_at(x, torch.clamp(n - 1, 0, C - 1))
    tok = _choose(x_last, params, lane, pos, cfg=cfg, policy=policy,
                  norm=head_norm)
    return tok, caches, pos.to(torch.int32)


def _choose_all(x, params, lane, steps, *, cfg, policy, norm):
    """The choice at every chunk position: x [B, C, E], steps [B, C] (the
    step each position's token is drawn at) -> [B, C] int32.  The lane's
    rows repeat C times, so position (b, j) draws with row b's seed."""
    B, C, E = x.shape
    flat = None if lane is None else {
        k: v.repeat_interleave(C) for k, v in lane.items()}
    tok = _choose(x.reshape(B * C, E), params, flat, steps.reshape(B * C),
                  cfg=cfg, policy=policy, norm=norm)
    return tok.reshape(B, C)


def forward_verify(params, tokens, pos0, chunk_len, caches, block_tables, *,
                   cfg, policy, lane=None, fused: bool = True,
                   paged_segments=None):
    """Multi-token verification for speculative decoding: one target pass
    over C = k + 1 consecutive tokens a row (the pending token and k draft
    proposals) into the paged pools, in place, returning the target's OWN
    choice at every position.  tokens: [B, C]; pos0: [B] the slot's
    decode position; chunk_len: [B] real tokens (<= C; the tail is
    padding); all device tensors.  -> (choices [B, C], caches, pos [B] =
    pos0 + chunk_len).

    choices[b, j] is what a decode step would emit after the prefix ending
    at position pos0 + j: greedy rows the argmax, sampled rows the (seed,
    step)-keyed Gumbel-max draw at step pos0 + j + 1, as `forward_decode`
    draws at pos + 1.  Rejected positions' KV sits beyond the committed
    pos: the rollback rewinds the fill count.  Nothing is read back on
    the host here.  Every segment must be paged (the chunk stack's
    gate)."""
    B, C = tokens.shape
    x, caches, head_norm = _run_chunk_stack(
        params, tokens, pos0, chunk_len, caches, block_tables, cfg=cfg,
        policy=policy, fused=fused, paged_segments=paged_segments)
    pos0 = pos0.to(torch.int64)
    steps = pos0[:, None] + 1 + torch.arange(C, device=tokens.device)[None]
    tok = _choose_all(x, params, lane, steps, cfg=cfg, policy=policy,
                      norm=head_norm)
    return tok, caches, (pos0 + chunk_len.to(torch.int64)).to(torch.int32)


def forward_verify_tree(params, tokens, pos0, chunk_len, depth, anc, caches,
                        block_tables, *, cfg, policy, lane=None,
                        fused: bool = True, paged_segments=None):
    """Tree-speculative verification: one target pass over C flattened
    token-tree nodes a row (node 0 the pending token, then the draft's
    branches in an ancestor-closed order), returning the target's own
    choice after every node.  tokens: [B, C]; pos0: [B]; chunk_len: [B]
    real nodes; depth: [B, C] each node's tree depth (node 0: 0); anc:
    [B, C, C] bool, anc[b, i, j] when node j is on node i's root path.
    -> (choices [B, C], caches, pos [B]).

    Node i's KV is written at pos0 + i (one position a node, as in
    `forward_verify`), while rope and the sampling step use its logical
    position pos0 + depth[i]: siblings at one depth share a rotation and
    a (seed, step) key, the state a step-by-step decode would have after
    committing that node's root path, so choices[b, i] is what plain
    decode (or `forward_verify` on the same chain) emits there, and the
    accepted path's KV is already rotated for its committed positions
    (the commit moves bytes only: `kv_cache.row_copy`).  The ancestor mask
    keeps each node blind to its sibling branches.  A single-branch chain
    (depth == node index, anc lower-triangular) reduces every override to
    `forward_verify`'s math."""
    pos0 = pos0.to(torch.int64)
    rope_pos = pos0[:, None] + depth.to(torch.int64)
    x, caches, head_norm = _run_chunk_stack(
        params, tokens, pos0, chunk_len, caches, block_tables, cfg=cfg,
        policy=policy, fused=fused, paged_segments=paged_segments,
        rope_pos=rope_pos, tree_mask=anc)
    tok = _choose_all(x, params, lane, rope_pos + 1, cfg=cfg, policy=policy,
                      norm=head_norm)
    return tok, caches, (pos0 + chunk_len.to(torch.int64)).to(torch.int32)


def forward_decode_topk(params, token, pos, caches, *, n: int, cfg, policy,
                        lane, block_tables, fused: bool = True,
                        paged_segments=None):
    """One AR step that also returns the sampler's runners-up: the tree
    proposer's draft step.  -> (next_token [B], alts [B, n], caches) with
    alts[:, 0] == next_token (the `forward_decode` choice, bit for bit)
    and alts[:, 1:] the next best ids of the same score
    (`core.embedding.sample_topn`).  The draft's cache advances one
    position; only the chain token is fed back.  Captured like
    `forward_decode`: no host value reaches the device."""
    x = _embed_step(params, token, pos, cfg=cfg, policy=policy)
    x, caches = _run_segments_decode(params, x, pos, caches, cfg=cfg,
                                     policy=policy, block_tables=block_tables,
                                     fused=fused,
                                     paged_segments=paged_segments)
    head_norm = _head_norm(params, cfg, fused)
    if head_norm is None:
        x = ops.norm(x, params["final_norm"], cfg.norm)
    tok, alts = sample_topn(x, params["embedding"]["unemb"],
                            dict(lane, step=pos + 1), n, cfg=cfg,
                            policy=policy, norm=head_norm)
    return tok, alts, caches
