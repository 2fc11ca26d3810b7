"""Radix-tree prefix/KV-cache reuse across serving requests.

RadixAttention-style (SGLang, Zheng et al. 2023) sharing of prefill
work: templated traffic (system prompts, few-shot preambles,
multi-turn conversations) re-sends the same token prefix over and
over, and the KV rows of a prefix depend only on the prefix itself --
so the KV a finished sequence computed can seed the next request that
shares its opening tokens. This module is the host-side index:

- a **radix tree** over token-id sequences; every non-root node owns
  an edge label (a token span) and the **KV block** for exactly those
  positions (``k``/``v``: ``[n_layers, n_kv_heads, len, head_dim]``
  numpy arrays, host memory -- HBM is never charged for cold cache),
- :meth:`match` walks a new prompt down the tree and returns the
  longest cached prefix as one concatenated donor KV view plus a
  **pin handle**: every node on the path is ref-counted until
  :meth:`release`, so eviction can never free a block an admission
  currently copies from,
- :meth:`insert` publishes a finished sequence's KV back, splitting
  edges at divergence points and storing only the *new* suffix,
- a **byte budget** (``capacity_bytes``) enforced by LRU eviction of
  unpinned leaves at insert time (``last_access`` is a logical tick,
  not wall clock -- deterministic under test clocks).

The tree stores *values*, not devices: the scheduler copies the donor
view into a decode slot's cache rows at fill time
(``InflightBatchingGenerator.fill_slot(cached_len=..., prefix_kv=...)``)
and the block is released immediately after -- pins live for the
match->fill window only. Because match results are numpy views,
eviction after release only drops the tree's reference; an in-flight
copy keeps its data alive via ordinary refcounting.

Correctness notes:

- KV rows are a function of (tokens, weights): the scheduler flushes
  the whole tree on every weight hot-swap
  (:meth:`ContinuousScheduler.poll_weights`), so a donor never mixes
  weight versions into a sequence.
- Rotary embeddings bind KV to absolute positions; a radix *prefix*
  match reuses rows at the same positions they were computed for, so
  position-dependent caches stay exact.
- Child traversal never iterates an unsorted dict: lookup is by first
  edge token (exact key), and maintenance walks use sorted child keys
  (deterministic across runs).
"""

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from realhf_tpu_torch.base import logging
from realhf_tpu_torch.obs import flight
from realhf_tpu_torch.obs import metrics as obs_metrics

logger = logging.getLogger("serving.prefix_cache")

#: flight event fired when pinned blocks hold the budget more than 2x
#: over ``capacity_bytes``
OVERCOMMIT_EVENT = "prefix_cache_overcommit"


class _Node:
    """One radix-tree node: an edge label plus the KV block covering
    exactly the label's positions. The root is the only node with an
    empty label and no KV."""

    __slots__ = ("tokens", "kv_k", "kv_v", "children", "parent", "ref",
                 "last_access")

    def __init__(self, tokens: np.ndarray,
                 kv_k: Optional[np.ndarray], kv_v: Optional[np.ndarray],
                 parent: Optional["_Node"]):
        self.tokens = tokens            # [L] int64/int32 edge label
        self.kv_k = kv_k                # [nl, nkv, L, hd] or None (root)
        self.kv_v = kv_v
        self.children: Dict[int, "_Node"] = {}  # first edge token -> node
        self.parent = parent
        self.ref = 0                    # outstanding pins (match handles)
        self.last_access = 0            # logical LRU tick

    @property
    def nbytes(self) -> int:
        if self.kv_k is None:
            return 0
        return self.kv_k.nbytes + self.kv_v.nbytes


@dataclasses.dataclass
class PrefixMatch:
    """Result of :meth:`RadixPrefixCache.match`. ``cached_len`` tokens
    of the prompt are covered by ``k``/``v`` (``[nl, nkv, cached_len,
    hd]`` views); pass them to ``fill_slot`` and then :meth:`release
    <RadixPrefixCache.release>` the ``handle``. A miss has
    ``cached_len == 0`` and an empty handle."""
    cached_len: int
    k: Optional[np.ndarray]
    v: Optional[np.ndarray]
    handle: List[_Node]


class RadixPrefixCache:
    """Byte-budgeted radix tree of reusable KV prefixes (module doc)."""

    def __init__(self, capacity_bytes: int):
        if capacity_bytes < 0:
            raise ValueError("capacity_bytes must be >= 0")
        self.capacity_bytes = capacity_bytes
        self._root = _Node(np.zeros((0,), np.int64), None, None, None)
        self._tick = 0
        self.bytes_used = 0
        self._overcommit_alarmed = False
        self.stats = dict(hits=0, misses=0, tokens_saved=0, inserts=0,
                          insert_skipped=0, evictions=0,
                          evicted_bytes=0, flushes=0,
                          overcommit_events=0)

    # ------------------------------------------------------------------
    def _touch(self, node: _Node):
        self._tick += 1
        node.last_access = self._tick

    # ------------------------------------------------------------------
    def match(self, tokens: np.ndarray,
              max_len: Optional[int] = None) -> PrefixMatch:
        """Longest cached prefix of ``tokens`` (optionally capped at
        ``max_len`` -- admission caps at ``len(prompt) - 1`` because
        the model still needs >= 1 real token to prefill a hidden
        state). Pins every node on the matched path; the caller MUST
        :meth:`release` the handle after copying the donor view."""
        tokens = np.asarray(tokens).reshape(-1)
        cap = len(tokens) if max_len is None else min(max_len,
                                                     len(tokens))
        node = self._root
        matched = 0
        ks: List[np.ndarray] = []
        vs: List[np.ndarray] = []
        handle: List[_Node] = []
        while matched < cap:
            child = node.children.get(int(tokens[matched]))
            if child is None:
                break
            span = child.tokens
            lim = min(len(span), cap - matched)
            # length of agreement within this edge
            eq = np.flatnonzero(
                span[:lim] != tokens[matched:matched + lim])
            take = int(eq[0]) if len(eq) else lim
            if take == 0:
                break
            child.ref += 1
            self._touch(child)
            handle.append(child)
            ks.append(child.kv_k[:, :, :take, :])
            vs.append(child.kv_v[:, :, :take, :])
            matched += take
            if take < len(span):
                break  # diverged (or capped) mid-edge
            node = child
        if matched == 0:
            self.stats["misses"] += 1
            return PrefixMatch(0, None, None, handle)
        self.stats["hits"] += 1
        self.stats["tokens_saved"] += matched
        k = ks[0] if len(ks) == 1 else np.concatenate(ks, axis=2)
        v = vs[0] if len(vs) == 1 else np.concatenate(vs, axis=2)
        return PrefixMatch(matched, k, v, handle)

    def release(self, handle: List[_Node]):
        """Unpin a match handle (idempotence is the caller's job)."""
        for node in handle:
            node.ref = max(0, node.ref - 1)
        if self.bytes_used > self.capacity_bytes:
            # pins were the only thing blocking eviction: retry, then
            # refresh the overcommit surface either way
            self._evict_to_budget()
        else:
            self._note_overcommit()

    def _note_overcommit(self):
        """Budget can only be transiently exceeded while pins are
        outstanding -- which used to be invisible. Surface it as a
        gauge, and as a flight event once the overcommit exceeds 2x
        ``capacity_bytes`` (re-armed when pressure drops back)."""
        over = max(0, self.bytes_used - self.capacity_bytes)
        obs_metrics.set_gauge("serving_prefix_overcommit_bytes", over)
        if over > 2 * self.capacity_bytes:
            if not self._overcommit_alarmed:
                self._overcommit_alarmed = True
                self.stats["overcommit_events"] += 1
                flight.record(OVERCOMMIT_EVENT,
                              overcommit_bytes=int(over),
                              bytes_used=int(self.bytes_used),
                              capacity_bytes=int(self.capacity_bytes))
                logger.warning(
                    "prefix cache overcommitted %d bytes (> 2x the "
                    "%d-byte budget) -- pinned blocks are blocking "
                    "eviction.", over, self.capacity_bytes)
        else:
            self._overcommit_alarmed = False

    # ------------------------------------------------------------------
    def insert(self, tokens: np.ndarray, k: np.ndarray,
               v: np.ndarray) -> int:
        """Publish a sequence's KV. ``k``/``v``: ``[nl, nkv, len(tokens),
        hd]``. Only the suffix not already in the tree is stored (the
        shared prefix stays shared). Returns the number of NEW tokens
        stored (0 when fully covered, skipped, or over budget)."""
        tokens = np.asarray(tokens).reshape(-1)
        if len(tokens) == 0:
            return 0
        if k.shape[2] != len(tokens) or v.shape[2] != len(tokens):
            logger.warning(
                "prefix_cache.insert: kv rows (%d/%d) != token count "
                "%d; skipping.", k.shape[2], v.shape[2], len(tokens))
            self.stats["insert_skipped"] += 1
            return 0
        node = self._root
        matched = 0
        while matched < len(tokens):
            child = node.children.get(int(tokens[matched]))
            if child is None:
                break
            span = child.tokens
            lim = min(len(span), len(tokens) - matched)
            eq = np.flatnonzero(
                span[:lim] != tokens[matched:matched + lim])
            take = int(eq[0]) if len(eq) else lim
            if take < len(span):
                # the new sequence diverges (or ends) mid-edge: split
                # the edge at `take`. A pinned node is never split --
                # an outstanding handle references its full block --
                # so a best-effort insert simply stops here.
                if child.ref > 0:
                    self.stats["insert_skipped"] += 1
                    return 0
                if take == 0:
                    break
                self._split(child, take)
            self._touch(child)
            matched += take
            node = child
        new = len(tokens) - matched
        if new == 0:
            self.stats["inserts"] += 1
            return 0  # fully covered already
        blk_k = np.ascontiguousarray(k[:, :, matched:, :])
        blk_v = np.ascontiguousarray(v[:, :, matched:, :])
        blk_bytes = blk_k.nbytes + blk_v.nbytes
        if blk_bytes > self.capacity_bytes:
            self.stats["insert_skipped"] += 1
            return 0  # the block alone busts the budget
        leaf = _Node(tokens[matched:].copy(), blk_k, blk_v, node)
        node.children[int(tokens[matched])] = leaf
        self._touch(leaf)
        self.bytes_used += blk_bytes
        self.stats["inserts"] += 1
        self._evict_to_budget(protect=leaf)
        return new

    def _split(self, node: _Node, at: int):
        """Split ``node``'s edge at ``at``: the existing object keeps
        the prefix part (so any external reference stays valid) and a
        new child inherits the tail + subtree."""
        tail = _Node(node.tokens[at:].copy(),
                     np.ascontiguousarray(node.kv_k[:, :, at:, :]),
                     np.ascontiguousarray(node.kv_v[:, :, at:, :]),
                     node)
        tail.children = node.children
        for c in tail.children.values():
            c.parent = tail
        tail.last_access = node.last_access
        node.kv_k = np.ascontiguousarray(node.kv_k[:, :, :at, :])
        node.kv_v = np.ascontiguousarray(node.kv_v[:, :, :at, :])
        node.tokens = node.tokens[:at].copy()
        node.children = {int(tail.tokens[0]): tail}

    # ------------------------------------------------------------------
    def _leaves(self) -> List[_Node]:
        """Evictable candidates: leaf nodes, deterministic order
        (sorted child walk -- never raw dict iteration)."""
        out: List[_Node] = []
        stack = [self._root]
        while stack:
            n = stack.pop()
            kids = [n.children[t] for t in sorted(n.children)]
            if not kids and n is not self._root:
                out.append(n)
            stack.extend(kids)
        return out

    def _evict_to_budget(self, protect: Optional[_Node] = None):
        """LRU-evict unpinned leaves until ``bytes_used`` fits the
        budget. A pinned (ref > 0) block is NEVER freed -- the budget
        may be transiently exceeded while pins are outstanding."""
        while self.bytes_used > self.capacity_bytes:
            cands = [n for n in self._leaves()
                     if n.ref == 0 and n is not protect]
            if not cands:
                break  # everything left is pinned (or the new block)
            victim = min(cands, key=lambda n: n.last_access)
            self._remove(victim)
        self._note_overcommit()

    def _remove(self, node: _Node):
        self.bytes_used -= node.nbytes
        self.stats["evictions"] += 1
        self.stats["evicted_bytes"] += node.nbytes
        parent = node.parent
        if parent is not None:
            parent.children.pop(int(node.tokens[0]), None)
        node.parent = None

    # ------------------------------------------------------------------
    def clear(self) -> int:
        """Drop every unpinned block (weight hot-swap: stale KV must
        never seed a sequence under new weights). Returns blocks
        dropped. Pinned nodes survive with their ancestor chain; they
        are released momentarily and evicted by the next insert."""
        dropped = 0
        # bottom-up: removing leaves exposes their parents
        while True:
            cands = [n for n in self._leaves() if n.ref == 0]
            if not cands:
                break
            for n in cands:
                self._remove(n)
                dropped += 1
        self.stats["flushes"] += 1
        return dropped

    # ------------------------------------------------------------------
    @property
    def n_nodes(self) -> int:
        n = 0
        stack = [self._root]
        while stack:
            cur = stack.pop()
            n += 1
            stack.extend(cur.children[t] for t in sorted(cur.children))
        return n - 1  # root excluded

    def snapshot(self) -> dict:
        return dict(self.stats, bytes=self.bytes_used,
                    capacity_bytes=self.capacity_bytes,
                    nodes=self.n_nodes,
                    overcommit_bytes=max(
                        0, self.bytes_used - self.capacity_bytes))


# ----------------------------------------------------------------------
# Pooled radix cache: nodes hold KV-POOL BLOCK IDS
# ----------------------------------------------------------------------
class _PNode:
    """Radix node over a paged KV pool: an edge label (token span at
    absolute positions ``[start, start + len)``) plus the POOL BLOCKS
    covering exactly those rows -- no private host copy. Because every
    sequence compacts its window from position 0, token ``p`` sits at
    offset ``p % block_len`` of its covering block in EVERY sequence,
    so adjacent nodes can share a boundary block (each holding its own
    pool reference) and a matched path resolves to one block per
    absolute block index with plain bookkeeping."""

    __slots__ = ("tokens", "start", "blocks", "children", "parent",
                 "ref", "last_access")

    def __init__(self, tokens: np.ndarray, start: int,
                 blocks: Tuple[int, ...], parent: Optional["_PNode"]):
        self.tokens = tokens
        self.start = start
        self.blocks = tuple(int(b) for b in blocks)
        self.children: Dict[int, "_PNode"] = {}
        self.parent = parent
        self.ref = 0
        self.last_access = 0


@dataclasses.dataclass
class PooledMatch:
    """Result of :meth:`PooledPrefixCache.match`: ``cached_len``
    (trimmed to a whole-block multiple -- partial tail blocks would be
    appended into by the new sequence and corrupt the shared copy) and
    the pool blocks covering rows ``[0, cached_len)``, to be ALIASED
    into the new slot's block table
    (``fill_slot(cached_len=..., cached_blocks=...)``). Release the
    ``handle`` after the fill, exactly like the host-cache flow."""
    cached_len: int
    blocks: Tuple[int, ...]
    handle: List[_PNode]


class PooledPrefixCache:
    """Radix prefix index over :class:`~realhf_tpu_torch.engine.kv_pool.
    KVPool` blocks: publication and prefix-hit prefill are refcount
    bookkeeping (zero KV copy for full-block spans), and eviction
    returns blocks straight to the pool both tenants share. Byte
    accounting is per-node (``len(node.blocks) * block_bytes``; a
    boundary block shared by two nodes counts twice -- the bound is on
    references held, which is what eviction can actually release)."""

    is_pooled = True

    def __init__(self, pool, capacity_bytes: int):
        if capacity_bytes < 0:
            raise ValueError("capacity_bytes must be >= 0")
        self.pool = pool
        self.capacity_bytes = capacity_bytes
        self._root = _PNode(np.zeros((0,), np.int64), 0, (), None)
        self._tick = 0
        self.bytes_used = 0
        self.rows = 0  # token rows indexed (frag-ratio numerator)
        self._overcommit_alarmed = False
        self.stats = dict(hits=0, misses=0, tokens_saved=0, inserts=0,
                          insert_skipped=0, evictions=0,
                          evicted_bytes=0, flushes=0,
                          overcommit_events=0)

    # shared helpers (identical semantics to the host-copy cache)
    _touch = RadixPrefixCache._touch
    _note_overcommit = RadixPrefixCache._note_overcommit

    @property
    def _blen(self) -> int:
        return self.pool.block_len

    # ------------------------------------------------------------------
    def match(self, tokens: np.ndarray,
              max_len: Optional[int] = None) -> PooledMatch:
        """Longest cached prefix, trimmed to a whole-block multiple.
        Pins every node on the path until :meth:`release` -- a pinned
        node's blocks can never be evicted, so the returned ids stay
        valid through the match->fill window."""
        tokens = np.asarray(tokens).reshape(-1)
        cap = len(tokens) if max_len is None else min(max_len,
                                                     len(tokens))
        node = self._root
        matched = 0
        handle: List[_PNode] = []
        blockmap: Dict[int, int] = {}
        while matched < cap:
            child = node.children.get(int(tokens[matched]))
            if child is None:
                break
            span = child.tokens
            lim = min(len(span), cap - matched)
            eq = np.flatnonzero(
                span[:lim] != tokens[matched:matched + lim])
            take = int(eq[0]) if len(eq) else lim
            if take == 0:
                break
            child.ref += 1
            self._touch(child)
            handle.append(child)
            # deepest node covering an absolute block wins: a child
            # recomputed its donor's partial tail block itself, so its
            # copy extends further than the parent's
            ab0 = child.start // self._blen
            for i, b in enumerate(child.blocks):
                blockmap[ab0 + i] = b
            matched += take
            if take < len(span):
                break
            node = child
        c = matched - matched % self._blen
        if c == 0:
            self.stats["misses"] += 1
            return PooledMatch(0, (), handle)
        self.stats["hits"] += 1
        self.stats["tokens_saved"] += c
        chain = tuple(blockmap[i] for i in range(c // self._blen))
        return PooledMatch(c, chain, handle)

    def release(self, handle: List[_PNode]):
        for node in handle:
            node.ref = max(0, node.ref - 1)
        if self.bytes_used > self.capacity_bytes:
            self._evict_to_budget()
        else:
            self._note_overcommit()

    # ------------------------------------------------------------------
    def insert(self, tokens: np.ndarray, blocks=None) -> int:
        """Publish a finished sequence: ``blocks`` is its pool chain
        covering rows ``[0, len(tokens))`` (from ``harvest(
        export_blocks=True)``). Only the uncovered suffix is indexed;
        the cache increfs exactly the blocks its new node references.
        The caller keeps ownership of its own references (free them
        after this returns). Returns the number of NEW tokens
        indexed."""
        tokens = np.asarray(tokens).reshape(-1)
        L = len(tokens)
        if L == 0 or blocks is None:
            return 0
        blocks = [int(b) for b in blocks]
        if len(blocks) < -(-L // self._blen):
            logger.warning(
                "pooled prefix insert: chain of %d block(s) cannot "
                "cover %d tokens; skipping.", len(blocks), L)
            self.stats["insert_skipped"] += 1
            return 0
        node = self._root
        matched = 0
        while matched < L:
            child = node.children.get(int(tokens[matched]))
            if child is None:
                break
            span = child.tokens
            lim = min(len(span), L - matched)
            eq = np.flatnonzero(
                span[:lim] != tokens[matched:matched + lim])
            take = int(eq[0]) if len(eq) else lim
            if take < len(span):
                if child.ref > 0:
                    self.stats["insert_skipped"] += 1
                    return 0  # never split a pinned node
                if take == 0:
                    break
                self._split(child, take)
            self._touch(child)
            matched += take
            node = child
        new = L - matched
        if new == 0:
            self.stats["inserts"] += 1
            return 0
        leaf_blocks = tuple(
            blocks[matched // self._blen: -(-L // self._blen)])
        blk_bytes = len(leaf_blocks) * self.pool.block_bytes
        if blk_bytes > self.capacity_bytes:
            self.stats["insert_skipped"] += 1
            return 0
        leaf = _PNode(tokens[matched:].copy(), matched, leaf_blocks,
                      node)
        self.pool.incref(leaf_blocks)
        node.children[int(tokens[matched])] = leaf
        self._touch(leaf)
        self.bytes_used += blk_bytes
        self.rows += new
        self.stats["inserts"] += 1
        self._evict_to_budget(protect=leaf)
        return new

    def _split(self, node: _PNode, at: int):
        """Split an edge at ``at`` (absolute position ``node.start +
        at``). Both halves reference the boundary block when the split
        is not block-aligned -- one extra pool reference, counted in
        the per-node byte accounting."""
        blen = self._blen
        split_abs = node.start + at
        tail_b0 = split_abs // blen - node.start // blen
        head_nb = (split_abs - 1) // blen - node.start // blen + 1
        tail = _PNode(node.tokens[at:].copy(), split_abs,
                      node.blocks[tail_b0:], node)
        tail.children = node.children
        for c in tail.children.values():
            c.parent = tail
        tail.last_access = node.last_access
        shared = head_nb > tail_b0  # boundary block in both halves
        if shared:
            self.pool.incref(node.blocks[tail_b0:tail_b0 + 1])
            self.bytes_used += self.pool.block_bytes
        node.blocks = node.blocks[:head_nb]
        node.tokens = node.tokens[:at].copy()
        node.children = {int(tail.tokens[0]): tail}

    # ------------------------------------------------------------------
    def _leaves(self) -> List[_PNode]:
        out: List[_PNode] = []
        stack = [self._root]
        while stack:
            n = stack.pop()
            kids = [n.children[t] for t in sorted(n.children)]
            if not kids and n is not self._root:
                out.append(n)
            stack.extend(kids)
        return out

    def _node_bytes(self, node: _PNode) -> int:
        return len(node.blocks) * self.pool.block_bytes

    def _evict_to_budget(self, protect: Optional[_PNode] = None):
        while self.bytes_used > self.capacity_bytes:
            cands = [n for n in self._leaves()
                     if n.ref == 0 and n is not protect]
            if not cands:
                break
            self._remove(min(cands, key=lambda n: n.last_access))
        self._note_overcommit()

    def _remove(self, node: _PNode):
        nb = self._node_bytes(node)
        self.bytes_used -= nb
        self.rows -= len(node.tokens)
        self.stats["evictions"] += 1
        self.stats["evicted_bytes"] += nb
        self.pool.free(node.blocks)
        parent = node.parent
        if parent is not None:
            parent.children.pop(int(node.tokens[0]), None)
        node.parent = None

    def evict_blocks(self, n: int) -> int:
        """Relieve pool pressure: LRU-evict unpinned leaves until at
        least ``n`` pool blocks actually returned to the free list (a
        shared block only returns when its last reference drops).
        Returns blocks freed -- the scheduler's evict-to-pool step on
        decode/admission OOM."""
        free0 = self.pool.n_free
        while self.pool.n_free - free0 < n:
            cands = [x for x in self._leaves() if x.ref == 0]
            if not cands:
                break
            self._remove(min(cands, key=lambda x: x.last_access))
        self._note_overcommit()
        return self.pool.n_free - free0

    # ------------------------------------------------------------------
    def clear(self) -> int:
        """Drop every unpinned node (weight hot-swap); their blocks
        return to the pool."""
        dropped = 0
        while True:
            cands = [n for n in self._leaves() if n.ref == 0]
            if not cands:
                break
            for n in cands:
                self._remove(n)
                dropped += 1
        self.stats["flushes"] += 1
        return dropped

    # ------------------------------------------------------------------
    @property
    def n_nodes(self) -> int:
        n = 0
        stack = [self._root]
        while stack:
            cur = stack.pop()
            n += 1
            stack.extend(cur.children[t] for t in sorted(cur.children))
        return n - 1

    def snapshot(self) -> dict:
        return dict(self.stats, bytes=self.bytes_used,
                    capacity_bytes=self.capacity_bytes,
                    nodes=self.n_nodes, rows=self.rows, pooled=True,
                    overcommit_bytes=max(
                        0, self.bytes_used - self.capacity_bytes))
