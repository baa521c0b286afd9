"""Speculative decoding: draft-model proposer + multi-token verification
(copy of the reference's serving/spec.py; pure Python and numpy).

Plain decode reads the whole weight set for ONE token a slot.  A small
*draft* LM proposes `k` tokens a round, and the *target* verifies them all
(plus the mandatory next token) in one multi-token pass over the paged KV
pools: the chunk stack (`lm.forward_verify` / `forward_verify_tree` on
`lm._run_chunk_stack`) pointed at decode-time positions.  Accepted tokens
cost one target weight read for up to k + 1 tokens; rejected tokens cost
their KV rows beyond the committed `pos`, which the rollback frees or
leaves masked.

Acceptance is *exact*.  The sampler is deterministic:
`core.embedding.sample_token` maps (residual, seed, position) to one token
(greedy rows an argmax, sampled rows a (seed, position)-keyed Gumbel-max
draw).  Verification computes, at every proposed position, the token the
target WOULD have chosen step by step, and accepts the longest prefix the
draft guessed.  Committed sequences are the target's own choices, greedy
and sampled; speculation changes how many target passes a sequence costs,
not which tokens it holds (on the CPU in fp32, token-identical to plain
decoding; in bf16 on a card the verify pass's M = B * C GEMMs round
differently from the decode step's M = B ones, so a near tie may flip).

Round lifecycle (`ModelRunner.spec_decode`):

  propose   k lockstep draft decode steps over the decode batch (the draft
            keeps a dense linear cache a slot and a `DraftState`), fed the
            target's per-slot sampling lane
  verify    one `launch/steps.make_verify_step` pass: the target forwards
            [pending token, d_1..d_k] into the slot's paged blocks and
            returns its own choice at every position
  commit    host-side longest-prefix acceptance (with EOS / max_new_tokens
            / max_seq trimming, so retirement matches plain decode), then
            rollback: pos rewinds to the committed length, trailing blocks
            held only for rejected tokens are freed, and the draft's
            cache rewinds with it
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.configs.base import ModelConfig

ACCEPTANCE_MODES = ("lossless", "greedy")


@dataclass(frozen=True)
class SpecConfig:
    """Speculative-decoding knobs for an InferenceEngine.

    draft       which model proposes: "self" (the target itself — 100%
                greedy acceptance, useful as the zero-risk upper bound and
                for overhead measurement), "auto" (derive a 2-layer draft
                from the target via configs.drafts.make_draft), or a
                registered config name (e.g. "gpt-j-draft") sharing the
                target's vocabulary.
    k           speculation length: draft tokens proposed per round; each
                verify step commits between 1 and k+1 tokens.
    acceptance  "lossless" (default): per-request greedy/sampled acceptance
                against the target's deterministic sampler — outputs are
                token-identical to non-speculative decoding for every
                request.  "greedy": the engine additionally REJECTS sampled
                submissions at submit time (a pure-greedy deployment that
                wants the constraint enforced, not silently absorbed).
    draft_seed  RNG seed used to initialize draft parameters when the
                caller does not supply `draft_params` (matching the
                engine's init-at-construction convention).
    branches    token-tree width: candidates the draft proposes per depth.
                1 (default) is the classic single-chain round.  b > 1
                builds a Medusa-style "caterpillar" tree per slot — the
                sampled draft chain t_1..t_k plus (b - 1) top-k sibling
                leaves hanging off each chain node — verified in ONE
                tree-masked target pass; a round then accepts the deepest
                root path whose nodes all match the target's own choices,
                which strictly contains the single-chain acceptance
                (the chain IS one of the root paths).  Still lossless.
    """
    draft: str = "auto"
    k: int = 4
    acceptance: str = "lossless"
    draft_seed: int = 0
    branches: int = 1

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"speculation length k must be >= 1: {self.k}")
        if self.branches < 1:
            raise ValueError(
                f"tree branch count must be >= 1: {self.branches}")
        if self.acceptance not in ACCEPTANCE_MODES:
            raise ValueError(
                f"acceptance must be one of {ACCEPTANCE_MODES}: "
                f"{self.acceptance!r}")
        if not self.draft:
            raise ValueError("draft must name a config, 'auto', or 'self'")


@dataclass
class DraftState:
    """Per-slot draft bookkeeping (owned by ModelRunner, one per seated
    GenerateTask when speculation is on).

    pos   valid draft-cache length for this slot: positions [0, pos) of
          the draft's dense cache row hold KV for the committed token
          sequence.  Lags the target's pos by at most one after an
          all-accept round (the bonus token's predecessor was never fed
          through the draft); the next round's proposal phase replays the
          gap from the known committed tokens.
    """
    pos: int


def spec_support_reason(cfg: ModelConfig) -> Optional[str]:
    """Why `cfg` cannot decode speculatively (None = statically eligible).

    Verification rides the chunked-prefill machinery, so the gate is the
    same cache-layout one: every segment's KV must live in the paged pool
    (multi-token verify writes straight into the slot's blocks and the
    rollback is a fill-count rewind).  Recurrent / ring / cross-attention
    state cannot rewind that way.  The engine additionally requires its
    runtime layout to carry the chunk stack (ModelRunner.supports_chunked).
    The reasons are the reference's, word for word.
    """
    if not cfg.vocab:
        return "no token vocabulary (encoder-only topology)"
    if cfg.has_ssm:
        return "recurrent SSM state cannot roll back rejected tokens"
    if cfg.sliding_window > 0:
        return ("sliding-window ring caches stay dense per-slot — no "
                "block-table fill count to rewind")
    if cfg.enc_schedule:
        return "encoder-decoder cross-attention memory is not paged"
    if cfg.n_patches:
        return "VLM patch prefixes are not supported in verify chunks"
    if cfg.rope_theta == 0:
        return "absolute-position (sinusoidal) models lack the chunk path"
    return None


def resolve_draft(spec: SpecConfig, cfg: ModelConfig) -> ModelConfig:
    """The draft ModelConfig for (spec, target): "self" / "auto" / a
    registered name, reduced alongside a reduced target, vocabulary
    checked against the target's (shared tokenizer is the contract that
    makes proposed ids comparable)."""
    from repro_torch.configs import get_config, make_draft
    if spec.draft == "self":
        return cfg
    if spec.draft == "auto":
        return make_draft(cfg)
    draft = get_config(spec.draft)
    if cfg.name.endswith("-reduced") and not draft.name.endswith("-reduced"):
        draft = draft.reduced()
    if draft.vocab != cfg.vocab:
        raise ValueError(
            f"draft {draft.name} does not share the target's tokenizer: "
            f"vocab {draft.vocab} != {cfg.vocab} ({cfg.name})")
    return draft


def accept_length(proposed: Sequence[int], target: Sequence[int]) -> int:
    """Longest accepted prefix: the number of leading positions where the
    draft's proposal equals the target's own (deterministic) choice for
    that position.  `target[j]` is the target's token for the position
    `proposed[j]` claims; acceptance stops at the first disagreement."""
    n = 0
    for d, c in zip(proposed, target):
        if int(d) != int(c):
            break
        n += 1
    return n


@dataclass
class TokenTree:
    """One slot's flattened proposal tree (build_tree output).

    Depth-major flatten order, chain node first within each depth:
    node 0 is the pending (already-committed) token, then per depth d the
    draft chain's token followed by its sibling candidates.  Any prefix of
    this order is ancestor-closed, so per-slot trees of different sizes
    batch into one fixed-width verify chunk by truncation + masking.

    tokens  [n] node token ids (tokens[0] = pending token)
    depth   [n] tree depth per node (depth[0] = 0; rope / sampling
            position of node i is pos0 + depth[i])
    parent  [n] parent node index (parent[0] = -1)
    anc     [n, n] bool ancestor-or-self matrix: anc[i, j] = node j lies
            on the root path of node i.  This IS the intra-chunk
            attention mask forward_verify_tree applies.
    chain   [n] bool: node sits on the draft's sampled chain (only chain
            nodes have children, so an accepted path leaves the chain at
            most once — at its final node).
    """
    tokens: np.ndarray
    depth: np.ndarray
    parent: np.ndarray
    anc: np.ndarray
    chain: np.ndarray

    @property
    def n_nodes(self) -> int:
        return int(self.tokens.shape[0])


def build_tree(pending: int, levels: Sequence[Sequence[int]]) -> TokenTree:
    """Flatten one slot's proposal levels into a TokenTree.

    `levels[d]` holds the candidate tokens for depth d + 1, with
    `levels[d][0]` the draft's sampled chain token (the token the draft
    actually fed forward) and the rest its same-step top-k siblings.
    Every depth's candidates attach to the previous depth's CHAIN node —
    the draft cache only ever advanced along the chain, so siblings are
    leaves.  A width-1 levels list reproduces the single-chain layout
    exactly: depth[i] == i and `anc` lower-triangular."""
    n = 1 + sum(len(lv) for lv in levels)
    tokens = np.zeros((n,), np.int32)
    depth = np.zeros((n,), np.int32)
    parent = np.full((n,), -1, np.int32)
    anc = np.zeros((n, n), bool)
    chain = np.zeros((n,), bool)
    tokens[0] = pending
    anc[0, 0] = True
    chain[0] = True
    i = 1
    par = 0
    for d, lv in enumerate(levels, start=1):
        nxt = i                          # this depth's chain node
        for j, t in enumerate(lv):
            tokens[i] = int(t)
            depth[i] = d
            parent[i] = par
            anc[i] = anc[par]
            anc[i, i] = True
            chain[i] = j == 0
            i += 1
        par = nxt
    return TokenTree(tokens=tokens, depth=depth, parent=parent, anc=anc,
                     chain=chain)


def accept_tree_path(tokens: Sequence[int], parent: Sequence[int],
                     choices: Sequence[int], n_nodes: int) -> List[int]:
    """Deepest accepted root path through a verified token tree.

    `choices[i]` is the target's own deterministic choice for the
    position AFTER node i's root path — acceptance of a child node j
    requires tokens[j] == choices[parent[j]], the same equality
    `accept_length` tests per chain position.  Walk from the root,
    descending into the (unique, by distinct-sibling construction) child
    matching the parent's choice, until no child matches.  Returns the
    accepted node indices in depth order, root excluded — so the round
    emits [choices[i] for i in [0] + path], mirroring the chain round's
    cand[:j + 1].  On a width-1 chain tree (parent[i] == i - 1) this
    reduces to exactly `accept_length` semantics."""
    path: List[int] = []
    cur = 0
    while True:
        want = int(choices[cur])
        nxt = -1
        for j in range(cur + 1, n_nodes):
            if int(parent[j]) == cur and int(tokens[j]) == want:
                nxt = j
                break
        if nxt < 0:
            return path
        path.append(nxt)
        cur = nxt


def trim_emitted(emitted: List[int], *, room: int,
                 eos_id: Optional[int]) -> List[int]:
    """Clamp one round's committed tokens to non-speculative retirement
    semantics: at most `room` tokens (max_new_tokens / max_seq budget,
    pre-clamped by the caller), cut at the first EOS inclusive — exactly
    where step-by-step decoding would have stopped."""
    out = emitted[:max(room, 1)]
    if eos_id is not None and eos_id in out:
        out = out[:out.index(eos_id) + 1]
    return out


def round_annotation(*, proposed: int, accepted: int, emitted: int,
                     tree_nodes: int = 0,
                     path_depths: Optional[Sequence[int]] = None,
                     branch_hits: int = 0) -> dict:
    """Span args summarizing one propose->verify->commit round (the
    reference's tracer reads them; the port's tracer waits for the
    observability item of its roadmap): proposal volume, acceptance, and
    — under token trees — node count, accepted root-path depths, and how
    many slots' accepted paths left the draft's sampled chain.  Pure
    observer; the commit loop computes these numbers either way."""
    ann = {"proposed": int(proposed), "accepted": int(accepted),
           "emitted": int(emitted),
           "accept_rate": (accepted / proposed if proposed else 0.0)}
    if tree_nodes:
        ann["tree_nodes"] = int(tree_nodes)
        ann["branch_hits"] = int(branch_hits)
        if path_depths:
            ann["accept_depths"] = [int(d) for d in path_depths]
    return ann


__all__ = ["SpecConfig", "DraftState", "TokenTree", "spec_support_reason",
           "resolve_draft", "accept_length", "accept_tree_path",
           "build_tree", "trim_emitted", "round_annotation"]
