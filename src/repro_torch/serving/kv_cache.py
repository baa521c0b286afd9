"""KV-cache paging for the serving engine (port of the reference's
serving/kv_cache.py: `BlockAllocator` and the admission scatter).

  BlockAllocator  refcounted free list over a global pool of fixed-size KV
                  blocks; the engine keeps a per-slot block table.
  prefill_scatter a freshly prefilled group's compact KV goes straight into
                  its assigned pool blocks (int8 pools: quantized on
                  admission), and its ring caches and SSM state into its
                  slots' rows, IN PLACE (the reference donates the caches
                  to a jitted scatter; the port writes them).
  block_copy      copy-on-write of one pool block (k / v, and the scales of
                  int8 pools) into another, IN PLACE: the captured decode
                  step holds the pools' addresses, so no pool is rebound.
  row_copy        one position's k / v moved across every paged pool, IN
                  PLACE: the tree-speculative commit compacts the accepted
                  path into the slot's committed positions.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import torch

from repro_torch.core.attention import kv_scale


class BlockAllocator:
    """Host-side refcounted free list over `num_blocks` KV blocks of
    `block_size` tokens.  `alloc` hands out blocks at refcount 1, `retain`
    adds a holder, `free` drops one; a block returns to the free list when
    its last holder lets go.  When the free list cannot satisfy an
    `alloc`, the optional `reclaim` hook (the prefix cache's LRU evictor)
    is asked to release index-only blocks first.  Invariant guards raise
    RuntimeError so a double free stays fatal under `python -O`."""

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 1 or block_size < 1:
            raise ValueError(f"pool needs >= 1 block of >= 1 token: "
                             f"({num_blocks}, {block_size})")
        self.num_blocks = num_blocks
        self.block_size = block_size
        # LIFO free list: freshly freed blocks are reused first
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self._free_set = set(self._free)
        self._ref: List[int] = [0] * num_blocks
        self.peak_used = 0
        # lazy-reclaim hook: called with the shortfall when alloc() would
        # otherwise fail; returns how many blocks it freed
        # (serving/prefix_cache.py registers its LRU evictor)
        self.reclaim: Optional[Callable[[int], int]] = None

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_used(self) -> int:
        return self.num_blocks - len(self._free)

    def refcount(self, block: int) -> int:
        return self._ref[block]

    def blocks_for(self, tokens: int) -> int:
        return -(-tokens // self.block_size)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Pop `n` blocks at refcount 1, or None (all-or-nothing) when the
        pool cannot satisfy it even after asking `reclaim` to evict cached
        blocks."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free) and self.reclaim is not None:
            self.reclaim(n - len(self._free))
        if n > len(self._free):
            return None
        out = []
        for _ in range(n):
            b = self._free.pop()
            self._free_set.discard(b)
            self._ref[b] = 1
            out.append(b)
        self.peak_used = max(self.peak_used, self.num_used)
        return out

    def retain(self, blocks: List[int]) -> None:
        for b in blocks:
            if self._ref[b] <= 0:
                raise RuntimeError(f"retain of unallocated block {b}")
            self._ref[b] += 1

    def free(self, blocks: List[int]) -> None:
        if len(set(blocks)) != len(blocks):
            raise RuntimeError(f"double free within batch: {blocks}")
        for b in blocks:
            if b in self._free_set or self._ref[b] <= 0:
                raise RuntimeError(f"double free of block {b}")
        for b in blocks:
            self._ref[b] -= 1
            if self._ref[b] == 0:
                self._free.append(b)
                self._free_set.add(b)


@torch.no_grad()
def prefill_scatter(caches, group_caches, slots, tables, *, block_size: int,
                    paged_segments=None):
    """Write a prefilled group's caches into the live decode caches in place.

    caches          live decode caches, per segment: {"k", "v"} pools
                    [count, NB + 1, BS, KV, hd] (trailing sink block; int8
                    pools with their scales {"ks", "vs"} [count, NB + 1,
                    KV]) or dense caches [count, B, W, KV, hd] (rings of a
                    window, or the dense layout's linear max_seq rows),
                    and / or per-slot SSM state {"h", "cx", "cbc"} [count,
                    B, ...], and / or a decoder layer's dense cross caches
                    {"ck", "cv"} [count, B, enc_seq_padded, KV, hd]
    group_caches    the group's caches: k / v [count, n, S, KV, hd] (rings:
                    S = W; linear caches: S <= W, the bucket), SSM state
                    [count, n, ...], ck / cv [count, n, enc_seq_padded,
                    KV, hd]
    slots           [n] int tensor: the decode slot of each group row
    tables          [n, MB] int tensor of assigned blocks (-1 beyond the
                    allocation: written to the sink); None when no segment
                    is paged
    paged_segments  per segment, whether its k / v are pools (the layout's
                    `segments`); None: every segment's are

    Pool leaves scatter per assigned block; every other leaf — dense
    caches included, though they too are named k / v, and the cross
    caches whole — scatters per slot row, a linear cache into its rows
    [0, S) (a speculative draft's prefill: the reference's dense scatter
    of a max_seq-row group, whose rows past S are zeros the draft never
    attends).
    An int8 pool is quantized on admission, as the reference's scatter
    does: admission writes every block from offset 0, so each block's scale
    is the per-head amax of the tokens that land in it (the bucket's pad
    rows included, the pad to a whole block zero), and a reused block's
    stale scale is replaced."""
    paged_segments = paged_segments or (True,) * len(caches)
    for seg, new, paged in zip(caches, group_caches, paged_segments):
        for key, leaf in seg.items():
            if key in ("ks", "vs"):
                continue                 # written beside their pools
            val = new[key]
            if not (paged and key in ("k", "v")):
                rows = slots.to(torch.int64)
                if key in ("k", "v") and val.shape[2] < leaf.shape[2]:
                    leaf[:, rows, :val.shape[2]] = val.to(leaf.dtype)
                else:
                    leaf[:, rows] = val.to(leaf.dtype)
                continue
            sink = leaf.shape[1] - 1
            count, n, S = val.shape[:3]
            ne = -(-S // block_size)
            pad = ne * block_size - S
            if pad:
                val = torch.nn.functional.pad(val, (0, 0, 0, 0, 0, pad))
            val = val.reshape(count, n * ne, block_size, *val.shape[3:])
            ids = tables[:, :ne].to(torch.int64)
            ids = torch.where(ids >= 0, ids, torch.full_like(ids, sink))
            ids = ids.reshape(-1)
            if leaf.dtype == torch.int8:
                xf = val.float()                  # [count, n*ne, BS, KV, hd]
                s = kv_scale(xf.abs().amax(dim=(2, 4)))
                q = torch.clamp(torch.round(xf / s[:, :, None, :, None]),
                                -127, 127)
                leaf[:, ids] = q.to(torch.int8)
                seg[key + "s"][:, ids] = s
            else:
                leaf[:, ids] = val.to(leaf.dtype)
    return caches


@torch.no_grad()
def block_copy(caches, src: int, dst: int, paged_segments=None):
    """Copy pool block `src` into pool block `dst` in every paged segment's
    k / v pools and, for int8 pools, their scales ks / vs, in place (the
    reference's `make_block_copy`; pools [count, NB + 1, BS, KV, hd],
    scales [count, NB + 1, KV]: dim 1 is the block for both).  The prefix
    cache copies a shared, partly filled block before a slot writes into
    it, so the writer mutates its private duplicate.  Dense leaves (ring
    caches, cross caches, SSM state) are untouched.  `paged_segments`: the
    layout's `segments`; None: every segment's k / v are pools."""
    paged_segments = paged_segments or (True,) * len(caches)
    for seg, paged in zip(caches, paged_segments):
        if not paged:
            continue
        for key in ("k", "v", "ks", "vs"):
            if key in seg:
                seg[key][:, dst].copy_(seg[key][:, src])
    return caches


@torch.no_grad()
def row_copy(caches, src_blk: int, src_off: int, dst_blk: int, dst_off: int,
             paged_segments=None):
    """Copy ONE cache position, (block, in-block offset), onto another
    across every paged k / v pool, in place (the reference's
    `make_row_copy`).  The tree-speculative commit compacts the accepted
    root path: tree nodes write their KV at pos0 + node index, the
    committed sequence needs depth d's KV at pos0 + d, and rope was
    applied at the node's logical position, so the move is bytes only.
    Sources sit above their destinations in flatten order and the moves
    run in increasing depth, so no move clobbers a pending source.  The
    int8 pools' scales stay (a block's scale cannot follow one row): the
    runner keeps int8 pools to the chain.  Dense leaves are untouched."""
    paged_segments = paged_segments or (True,) * len(caches)
    for seg, paged in zip(caches, paged_segments):
        if not paged:
            continue
        for key in ("k", "v"):
            if key in seg:
                seg[key][:, dst_blk, dst_off].copy_(
                    seg[key][:, src_blk, src_off])
    return caches
