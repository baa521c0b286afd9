"""Prefix cache: refcounted copy-on-write KV block sharing across requests
(copy of the reference's serving/prefix_cache.py; host-only).

Re-prefilling a shared prompt prefix (a system prompt, a few-shot
preamble) for every request is the largest redundant traffic of serving.
The block-paged pool is the substrate for reuse: KV for position p depends
only on tokens [0, p] (causal attention), so two requests whose prompts
share a prefix can share the pool blocks that hold that prefix's KV.

    PrefixCache     radix/trie index over *token content*: each node owns one
                    pool block and covers a tuple of tokens.  Edges are keyed
                    by a rolling hash of that tuple; every hash hit is
                    verified against the node's stored tokens before it is
                    accepted, so a collision degrades to a miss, never to a
                    wrong share.  Full-block nodes (block_size tokens) form
                    the trie spine; partially filled tails hang off their
                    parent as leaf nodes and match by longest common prefix.
    lookup()        longest cached prefix of a prompt -> (blocks, tokens).
                    A partial match *inside* a block is still a hit: the
                    suffix prefill copies the block on write before it
                    overwrites the positions past the match.
    insert()        index a slot's committed tokens: full prompt blocks at
                    admission, the partial tail (prompt + sampled output) at
                    retirement.  Each newly indexed block gains one allocator
                    reference; content already present is deduplicated
                    (first writer wins).
    reclaim()       lazy LRU eviction, registered as `BlockAllocator.reclaim`:
                    when `alloc()` would fail, index-only leaf blocks
                    (allocator refcount 1: no live slot holds them) are
                    evicted oldest first until the shortfall is covered, so a
                    retired request's blocks stay warm exactly as long as the
                    pool has room for them.

Sharing is sampling-independent by construction: the index key is token
content, and KV depends only on token content.  The runner keeps the write
discipline that makes sharing safe: a block is only ever written by a slot
that holds it at refcount 1 (a fresh allocation or a copy-on-write
duplicate).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from repro_torch.serving.kv_cache import BlockAllocator


class _Node:
    """One indexed pool block.  `key` is the tuple of tokens the block
    covers (len == block_size for spine nodes, < block_size for partial
    tails), kept for collision verification; `hash` is its rolling hash —
    the dict key under which the node is indexed; `stamp` is the LRU clock
    of the last lookup/insert that touched this node's path."""
    __slots__ = ("key", "hash", "block", "tokens", "parent", "children",
                 "partials", "stamp")

    def __init__(self, key: tuple, block: int, parent: Optional["_Node"]):
        self.key = key
        self.hash = _rhash(key)
        self.block = block
        self.tokens = len(key)
        self.parent = parent
        self.children: dict = {}    # rolling hash -> [_Node] (full blocks)
        self.partials: dict = {}    # rolling hash -> [_Node] (partial tails)
        self.stamp = 0


# Polynomial rolling hash over token ids, mod the Mersenne prime 2^61 - 1.
# Content-derived and incremental (h extends token-by-token), so the index
# key for a block is a single machine word regardless of block_size.  Hash
# equality is never trusted on its own — see _get().
_HASH_BASE = 1_000_003
_HASH_MOD = (1 << 61) - 1


def _rhash(toks, h: int = 0) -> int:
    for t in toks:
        h = (h * _HASH_BASE + int(t) + 1) % _HASH_MOD
    return h


def _get(group: dict, key: tuple) -> Optional[_Node]:
    """Collision-safe probe: a node is returned only if its stored token
    tuple matches `key` exactly.  A hash collision (same bucket, different
    tokens) therefore reads as a miss."""
    for cand in group.get(_rhash(key), ()):
        if cand.key == key:
            return cand
    return None


def _put(group: dict, node: _Node) -> None:
    group.setdefault(node.hash, []).append(node)


def _unlink(group: dict, node: _Node) -> None:
    bucket = group[node.hash]
    bucket.remove(node)
    if not bucket:
        del group[node.hash]


def _nodes(group: dict):
    for bucket in group.values():
        yield from bucket


def _common(a, b) -> int:
    n = min(len(a), len(b))
    for i in range(n):
        if a[i] != b[i]:
            return i
    return n


class PrefixCache:
    """Radix index + LRU pool over a `BlockAllocator`.

    max_blocks caps how many pool blocks the index may hold references to
    (None = bounded only by pool pressure via lazy reclaim)."""

    def __init__(self, allocator: BlockAllocator, block_size: int,
                 max_blocks: Optional[int] = None):
        if max_blocks is not None and max_blocks < 0:
            raise ValueError(f"max_blocks must be >= 0: {max_blocks}")
        self.allocator = allocator
        self.block_size = block_size
        self.max_blocks = max_blocks
        self._root = _Node((), -1, None)     # sentinel, owns no block
        self._clock = 0
        self._n_blocks = 0
        # counters — cumulative; engine.stats() diffs them against a
        # reset_stats() baseline
        self.lookups = 0
        self.hits = 0
        self.hit_tokens = 0
        self.inserted_blocks = 0
        self.evicted_blocks = 0
        allocator.reclaim = self.reclaim

    @property
    def cached_blocks(self) -> int:
        """Pool blocks the index currently holds a reference to."""
        return self._n_blocks

    # -- lookup ------------------------------------------------------------

    def lookup(self, tokens, *, limit: Optional[int] = None,
               touch: bool = True, record: bool = True
               ) -> Tuple[List[int], int]:
        """Longest cached prefix of `tokens` (capped at `limit` tokens).

        Returns (blocks, matched): `blocks[i]` holds the KV for positions
        [i*bs, (i+1)*bs) of the match; the last block may be matched only
        partially (matched % bs != 0) — its positions past the match carry
        other content and must be copy-on-written before reuse.

        The returned blocks are NOT retained — the caller must
        `allocator.retain()` them before anything that could trigger
        eviction (an alloc, another insert).  `touch=False, record=False`
        is the scheduler's peek: no LRU update, no hit-rate skew."""
        toks = [int(t) for t in tokens]
        if limit is not None:
            toks = toks[:limit]
        bs = self.block_size
        node = self._root
        path = [node]
        blocks: List[int] = []
        matched = 0
        i = 0
        while i + bs <= len(toks):
            child = _get(node.children, tuple(toks[i:i + bs]))
            if child is None:
                break
            node = child
            path.append(node)
            blocks.append(node.block)
            matched += bs
            i += bs
        # best partial continuation: longest common prefix of the remaining
        # tokens with any child at this node (a full-block child matched
        # only partway is as good as a stored partial tail — causality makes
        # its leading positions valid for us)
        rest = toks[i:]
        best = best_cp = None
        for group in (node.partials, node.children):
            for cand in _nodes(group):
                cp = _common(cand.key, rest)
                if cp > 0 and (best is None or cp > best_cp):
                    best, best_cp = cand, cp
        if best is not None:
            path.append(best)
            blocks.append(best.block)
            matched += best_cp
        if record:
            self.lookups += 1
            if matched > 0:
                self.hits += 1
                self.hit_tokens += matched
        if touch and matched > 0:
            self._clock += 1
            for n in path:
                n.stamp = self._clock
        return blocks, matched

    # -- insert ------------------------------------------------------------

    def insert(self, tokens, blocks: List[int]) -> None:
        """Index committed content: `blocks[i]` holds the KV of positions
        [i*bs, (i+1)*bs) of `tokens`.  A final partial block (len(tokens)
        not a block multiple) is indexed as a partial-tail leaf.  Every
        block the index newly references is retained; content already
        indexed keeps its existing block (the caller's duplicate stays
        owned by the caller and dies with it)."""
        toks = [int(t) for t in tokens]
        bs = self.block_size
        if len(blocks) < -(-len(toks) // bs):
            raise ValueError(f"{len(blocks)} blocks cannot cover "
                             f"{len(toks)} tokens")
        self._clock += 1
        node = self._root
        node.stamp = self._clock
        i = bi = 0
        while i + bs <= len(toks):
            key = tuple(toks[i:i + bs])
            child = _get(node.children, key)
            if child is None:
                child = _Node(key, blocks[bi], node)
                _put(node.children, child)
                self.allocator.retain([child.block])
                self._n_blocks += 1
                self.inserted_blocks += 1
            child.stamp = self._clock
            node = child
            i += bs
            bi += 1
        rest = tuple(toks[i:])
        if rest and _get(node.partials, rest) is None:
            tail = _Node(rest, blocks[bi], node)
            _put(node.partials, tail)
            tail.stamp = self._clock
            self.allocator.retain([tail.block])
            self._n_blocks += 1
            self.inserted_blocks += 1
        if self.max_blocks is not None:
            while self._n_blocks > self.max_blocks and self._evict_lru():
                pass

    # -- eviction ----------------------------------------------------------

    def _evictable(self) -> List[_Node]:
        """Leaf nodes whose block only the index holds (allocator refcount
        1): safe to drop.  Interior nodes become evictable once their
        subtree is gone; pinned nodes (a live slot shares the block) keep
        their whole ancestor path alive."""
        out = []
        stack = [self._root]
        while stack:
            n = stack.pop()
            stack.extend(_nodes(n.children))
            stack.extend(_nodes(n.partials))
            if (n is not self._root and not n.children and not n.partials
                    and self.allocator.refcount(n.block) == 1):
                out.append(n)
        return out

    def _evict_lru(self) -> bool:
        victims = self._evictable()
        if not victims:
            return False
        node = min(victims, key=lambda n: n.stamp)
        parent = node.parent
        if node.tokens == self.block_size:
            _unlink(parent.children, node)
        else:
            _unlink(parent.partials, node)
        self.allocator.free([node.block])
        self._n_blocks -= 1
        self.evicted_blocks += 1
        return True

    def reclaim(self, shortfall: int) -> int:
        """`BlockAllocator.reclaim` hook: evict LRU index-only blocks back
        to the free list until `shortfall` blocks are recovered or nothing
        evictable remains.  Returns the number of blocks freed."""
        freed = 0
        while freed < shortfall and self._evict_lru():
            freed += 1
        return freed

    def clear(self) -> int:
        """Drop every unpinned index entry (testing / manual flush)."""
        freed = 0
        while self._evict_lru():
            freed += 1
        return freed

    # -- invariants --------------------------------------------------------

    def index_blocks(self) -> set:
        """The set of pool blocks the index currently references
        (telemetry / invariant tests)."""
        out = set()
        stack = list(_nodes(self._root.children)) \
            + list(_nodes(self._root.partials))
        while stack:
            n = stack.pop()
            out.add(n.block)
            stack.extend(_nodes(n.children))
            stack.extend(_nodes(n.partials))
        return out

    def check(self) -> None:
        """Structural invariants (tests call this after every operation):
        node count matches the block counter, partial tails are leaves,
        every node is filed under the rolling hash of its token content,
        every indexed block is live (refcount >= 1) and off the free list,
        and no block is indexed twice."""
        seen = set()
        count = 0
        stack = [(self._root, True)]
        while stack:
            n, is_root = stack.pop()
            for group in (n.children, n.partials):
                for h, bucket in group.items():
                    for c in bucket:
                        if c.hash != h or _rhash(c.key) != h:
                            raise AssertionError(
                                f"node filed under stale hash {h}")
                        stack.append((c, False))
            for p in _nodes(n.partials):
                if p.children or p.partials:
                    raise AssertionError("partial tail is not a leaf")
            if is_root:
                continue
            count += 1
            if n.block in seen:
                raise AssertionError(f"block {n.block} indexed twice")
            seen.add(n.block)
            if self.allocator.refcount(n.block) < 1:
                raise AssertionError(f"indexed block {n.block} is free")
        if count != self._n_blocks:
            raise AssertionError(f"node count {count} != "
                                 f"counter {self._n_blocks}")
