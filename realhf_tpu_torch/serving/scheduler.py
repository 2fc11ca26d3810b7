"""Iteration-level continuous scheduler over decode slots.

Orca-style scheduling for the rollout service: between decode
iterations the scheduler (1) installs pending weight swaps, (2)
evicts sequences that can no longer produce a useful result (deadline
passed, or doomed to exceed the staleness bound after a weight jump),
(3) admits queued requests into free slots (prefill interleaved with
decoding of the other slots), (4) runs one decode chunk, and (5)
harvests finished sequences, stamping each with the weight versions it
was generated under.

The backend contract (duck-typed; satisfied by
``engine.inflight.InflightBatchingGenerator`` and by test fakes)::

    n_slots: int                   chunk: int (decode steps per chunk)
    free_slots() -> List[int]
    fill_slot(slot, int_id, prompt)
    decode_chunk(generator)
    harvest() -> List[FinishedSequence]   # frees slots
    release_slot(slot)                    # abort, frees slot
    swap_params(params)
    snapshot_slot(slot) -> (tokens, logprobs)
    snapshot_slots(slots) -> {slot: (tokens, logprobs)}  # optional:
        one bundled device fetch for streaming (falls back to
        per-slot snapshot_slot when absent)

Counters make the continuous-batching win measurable: ``decode_steps``
(an upper bound -- the backend's chunk loop may early-exit) versus
``tokens_out``, which is exactly the number of decode passes a
sequential (one-request-at-a-time) server would have paid.
"""

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from realhf_tpu_torch.base import logging
from realhf_tpu_torch.obs import metrics as obs_metrics
from realhf_tpu_torch.obs import tracing
from realhf_tpu_torch.serving import protocol
from realhf_tpu_torch.serving.request_queue import (
    GenRequest,
    RequestQueue,
    count_expired,
)
from realhf_tpu_torch.serving.weight_sync import WeightSync

logger = logging.getLogger("serving.scheduler")


@dataclasses.dataclass
class ServeEvent:
    """One scheduler-step outcome, routed to clients by the server.

    kinds: ``started`` (entered a slot), ``tokens`` (incremental
    delta), ``done`` (finished, data carries the FinishedRollout),
    ``stale`` (finished/evicted beyond the staleness bound),
    ``expired`` (deadline passed while decoding), ``cancelled``,
    ``rejected`` (the backend refused the prompt at prefill time --
    admission normally catches this first via ``max_prompt_len``).
    """
    kind: str
    rid: str
    data: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class FinishedRollout:
    rid: str
    tokens: np.ndarray
    logprobs: np.ndarray
    no_eos: bool
    #: weight version installed when the sequence entered its slot --
    #: the behavior-policy version async RLHF consumers key on.
    weight_version: int
    #: version installed when it finished (== weight_version unless a
    #: hot-swap happened mid-stream).
    weight_version_final: int
    queued_secs: float = 0.0
    serve_secs: float = 0.0
    #: speculative-decoding accounting for this request (0/0 when the
    #: drafter is off); accept rate = spec_accepted / spec_proposed
    spec_proposed: int = 0
    spec_accepted: int = 0


@dataclasses.dataclass
class _ActiveSeq:
    int_id: int
    slot: int
    req: GenRequest
    version_start: int
    streamed: int = 0  # tokens already reported via `tokens` events


class ContinuousScheduler:
    """Admission/eviction + decode driving over a slot backend."""

    def __init__(self, backend, queue: RequestQueue,
                 weight_sync: Optional[WeightSync] = None,
                 max_staleness: Optional[int] = None,
                 stream_tokens: bool = True,
                 prefix_cache=None,
                 clock: Callable[[], float] = time.monotonic):
        self.backend = backend
        self.queue = queue
        self.weight_sync = weight_sync or WeightSync()
        self.max_staleness = max_staleness
        self.stream_tokens = stream_tokens
        # radix prefix/KV reuse (serving/prefix_cache.py). Two
        # substrate pairings are engaged, the rest degrade with a
        # warning:
        # - POOLED cache + paged backend (shared engine/kv_pool.py
        #   pool): prefix hits alias blocks, publication is refcount
        #   bookkeeping, eviction relieves decode OOM pressure;
        # - host-copy cache + dense backend implementing the prefix
        #   fill + KV export extensions (the pre-pool flow).
        self.prefix_cache = prefix_cache
        self._pooled = bool(getattr(prefix_cache, "is_pooled", False))
        backend_pool = getattr(backend, "kv_pool", None)
        if prefix_cache is None:
            self._prefix_capable = False
        elif self._pooled:
            self._prefix_capable = backend_pool is not None
            if not self._prefix_capable:
                logger.warning(
                    "pooled prefix cache configured but backend %s "
                    "has no kv_pool; running without reuse.",
                    type(backend).__name__)
            elif prefix_cache.pool is not backend_pool:
                raise ValueError(
                    "prefix cache and backend must share ONE KVPool "
                    "-- that sharing is the point of the pool")
        else:
            self._prefix_capable = (
                getattr(backend, "supports_prefix_fill", False)
                and backend_pool is None)
            if not self._prefix_capable:
                logger.warning(
                    "prefix cache configured but backend %s %s; "
                    "running without reuse.", type(backend).__name__,
                    "is paged (use PooledPrefixCache)"
                    if backend_pool is not None
                    else "lacks supports_prefix_fill")
        self._clock = clock
        self._active: Dict[int, _ActiveSeq] = {}  # int_id -> seq
        self._by_slot: Dict[int, int] = {}        # slot -> int_id
        self._next_id = 0
        #: one-deep holding slot for a request popped from the queue
        #: that the KV pool cannot admit yet (admission is gated on
        #: free blocks, not slots): retried first next step, so pool
        #: backpressure defers work instead of dropping it
        self._parked = None
        self.last_pool_stats: Optional[Dict] = None
        self.stats = dict(prefills=0, decode_chunks=0, decode_steps=0,
                          tokens_out=0, finished=0, expired=0, stale=0,
                          cancelled=0, swaps=0, fill_failed=0,
                          sequential_equiv_steps=0,
                          prefix_hits=0, prefix_misses=0,
                          prefix_evictions=0, prefix_tokens_saved=0,
                          spec_proposed=0, spec_accepted=0,
                          kv_oom_evictions=0, kv_relief_blocks=0,
                          kv_parked=0)

    def _count(self, key: str, n: int = 1):
        """Bump a scheduler counter AND its mirror in the process
        metrics registry, so the worker health surface's Prometheus
        export (``serving_<key>_total``) tracks the same numbers the
        ``stats`` command reports."""
        self.stats[key] += n
        obs_metrics.inc(f"serving_{key}_total", n)

    def _count_expired(self, req: GenRequest):
        """Deadline expiry keeps the ``stats`` mirror but carries the
        admission class on the metric
        (``serving_expired_total{class}``), matching the queue-side
        shunt in ``request_queue.pop``."""
        self.stats["expired"] += 1
        count_expired(req)

    # ------------------------------------------------------------------
    @property
    def n_live(self) -> int:
        return len(self._active)

    def idle(self) -> bool:
        return (not self._active and len(self.queue) == 0
                and self._parked is None)

    def active_rids(self) -> List[str]:
        return [s.req.rid for s in self._active.values()]

    def take_parked(self):
        """Hand back the pool-backpressure holding slot (the server's
        drain bounces it alongside the queued requests)."""
        req, self._parked = self._parked, None
        return [req] if req is not None else []

    # ------------------------------------------------------------------
    def cancel(self, rid: str) -> bool:
        """Abort an ACTIVE sequence (queued ones are cancelled at the
        queue; a pool-parked one counts too). Frees the slot
        immediately."""
        if self._parked is not None and self._parked.rid == rid:
            self._parked = None
            self._count("cancelled")
            return True
        for int_id, seq in list(self._active.items()):
            if seq.req.rid == rid:
                self._evict(int_id)
                self._count("cancelled")
                return True
        return False

    def _evict(self, int_id: int):
        seq = self._active.pop(int_id)
        self._by_slot.pop(seq.slot, None)
        self.backend.release_slot(seq.slot)

    # ------------------------------------------------------------------
    def poll_weights(self) -> Optional[int]:
        """Install pending weights, if any. Safe whenever no decode
        chunk is in flight -- ``step`` calls it between iterations, and
        the server calls it directly while idle so a pushed version
        becomes visible to admission without waiting for traffic.
        Returns the newly installed version or None."""
        swapped = self.weight_sync.poll(self.backend.swap_params)
        if swapped is not None:
            self._count("swaps")
            if self.prefix_cache is not None:
                # cached KV is a function of (tokens, WEIGHTS): donor
                # rows computed under the old version must never seed
                # a sequence under the new one
                dropped = self.prefix_cache.clear()
                if dropped:
                    self._count("prefix_evictions", dropped)
                logger.info("Weight swap to v%d flushed %d prefix-"
                            "cache block(s).", swapped, dropped)
        return swapped

    # ------------------------------------------------------------------
    def step(self, generator=None, admit: bool = True) -> List[ServeEvent]:
        """One serve iteration; returns the events it produced.
        ``generator`` (a ``torch.Generator`` on the backend's device)
        drives sampling; greedy decoding ignores it."""
        events: List[ServeEvent] = []
        now = self._clock()

        # 1. weight swap between iterations
        self.poll_weights()
        version = self.weight_sync.version

        # 2. evictions: deadline / doomed-stale sequences stop burning
        #    decode steps right away
        for int_id, seq in list(self._active.items()):
            if (seq.req.deadline is not None
                    and seq.req.deadline <= now):
                self._evict(int_id)
                self._count_expired(seq.req)
                events.append(ServeEvent(protocol.EXPIRED, seq.req.rid))
            elif self._is_stale(seq, version):
                self._evict(int_id)
                self._count("stale")
                events.append(ServeEvent(protocol.STALE, seq.req.rid,
                                         self._stale_info(seq, version)))

        # 3. admission: prefill queued requests into free slots.
        #    Paged backends gate on POOL FREE BLOCKS, not just slots:
        #    a request the pool cannot take is parked (backpressure,
        #    retried next step after evict-to-pool relief) instead of
        #    consuming a slot it cannot fill.
        if admit:
            for slot in self.backend.free_slots():
                req, self._parked = self._parked, None
                if req is None:
                    req = self.queue.pop()
                if req is None:
                    break
                if req.deadline is not None and req.deadline <= now:
                    # expired while parked (queue.pop filters its own)
                    self._count_expired(req)
                    events.append(ServeEvent(protocol.EXPIRED, req.rid))
                    continue
                if not self._pool_admissible(req):
                    self._parked = req
                    self._count("kv_parked")
                    break
                req.started_at = now
                int_id = self._next_id
                self._next_id += 1
                try:
                    self._fill_slot(slot, int_id, req)
                except Exception as e:  # noqa: BLE001 - one bad
                    # request must not crash the serve loop and drop
                    # every other in-flight sequence
                    logger.error("fill_slot failed for %s: %r",
                                 req.rid, e)
                    self.backend.release_slot(slot)
                    self._count("fill_failed")
                    events.append(ServeEvent(
                        protocol.REJECTED, req.rid,
                        dict(reason=protocol.REASON_FILL_FAILED,
                             error=str(e), retry_after=None)))
                    continue
                self._active[int_id] = _ActiveSeq(
                    int_id, slot, req, version_start=version)
                self._by_slot[slot] = int_id
                self._count("prefills")
                events.append(ServeEvent(protocol.STARTED, req.rid,
                                         dict(weight_version=version)))

        # 4. one decode chunk over every live slot
        if self._active:
            # one span covers ALL live sequences: the timeline shows
            # chunk-interleaved serving, not per-request decode walls
            with tracing.span("serve:decode_chunk",
                              n_live=len(self._active),
                              weight_version=version):
                self._decode_with_relief(generator, events)
            self._count("decode_chunks")
            self._count("decode_steps", self.backend.chunk)

        # 5. harvest + streaming deltas. Pooled caches take BLOCK IDS
        #    (publication = refcount bookkeeping, zero device
        #    transfer); host caches take the bundled KV download; no
        #    cache, no export.
        if self._prefix_capable and self._pooled:
            harvested = self.backend.harvest(export_blocks=True)
        elif self._prefix_capable:
            harvested = self.backend.harvest(export_kv=True)
        else:
            harvested = self.backend.harvest()
        for fs in harvested:
            seq = self._active.pop(fs.request_id, None)
            if seq is None:
                # evicted this very step; still release the receiver-
                # owned block refs a pooled export attached
                if self._pooled and getattr(fs, "blocks", None):
                    self.backend.kv_pool.free(fs.blocks)
                continue
            self._by_slot.pop(seq.slot, None)
            self._count("tokens_out", len(fs.tokens))
            self._count("sequential_equiv_steps", len(fs.tokens))
            if getattr(fs, "spec_proposed", 0):
                self._count("spec_proposed", fs.spec_proposed)
                self._count("spec_accepted", fs.spec_accepted)
            self._publish_kv(seq, fs, version)
            if self._is_stale(seq, version):
                self._count("stale")
                events.append(ServeEvent(protocol.STALE, seq.req.rid,
                                         self._stale_info(seq, version)))
                continue
            self._count("finished")
            out = FinishedRollout(
                rid=seq.req.rid, tokens=fs.tokens, logprobs=fs.logprobs,
                no_eos=fs.no_eos, weight_version=seq.version_start,
                weight_version_final=version,
                spec_proposed=getattr(fs, "spec_proposed", 0),
                spec_accepted=getattr(fs, "spec_accepted", 0),
                queued_secs=max(0.0, (seq.req.started_at or now)
                                - seq.req.submitted_at),
                serve_secs=max(0.0, now - (seq.req.started_at or now)))
            self.queue.note_service_time(now - seq.req.submitted_at)
            events.append(ServeEvent(protocol.DONE, seq.req.rid,
                                     dict(result=out)))
        if self.stream_tokens:
            # one bundled device fetch for every live slot -- a
            # per-slot snapshot_slot pays one sync round-trip each
            snaps = self._snapshot_active()
            for seq in self._active.values():
                tokens, logprobs = snaps[seq.slot]
                if len(tokens) > seq.streamed:
                    events.append(ServeEvent(
                        protocol.TOKENS, seq.req.rid,
                        dict(tokens=tokens[seq.streamed:],
                             logprobs=logprobs[seq.streamed:],
                             offset=seq.streamed)))
                    seq.streamed = len(tokens)
        self._update_pool_gauges()
        return events

    # ------------------------------------------------------------------
    # KV-pool pressure management: admission backpressure and
    # evict-to-pool relief
    # ------------------------------------------------------------------
    def _pool_admissible(self, req: GenRequest) -> bool:
        """Admit while blocks remain: a paged backend names the
        free-list blocks a fill of this prompt will take; when the
        pool is short, evict-to-pool (unpinned prefix-cache blocks)
        runs BEFORE the request is parked."""
        if getattr(self.backend, "kv_pool", None) is None:
            return True
        need = self.backend.admission_blocks_needed(len(req.prompt))
        pool = self.backend.kv_pool
        if pool.n_free >= need:
            return True
        self._relieve_pool(need - pool.n_free)
        return pool.n_free >= need

    def _relieve_pool(self, shortfall: int) -> int:
        """Return KV blocks to the pool by evicting unpinned prefix-
        cache nodes (LRU): cold cached prefixes are the one reserve
        that costs nothing live to give back."""
        if (shortfall <= 0 or not self._pooled
                or not self._prefix_capable):
            return 0
        freed = self.prefix_cache.evict_blocks(shortfall)
        if freed:
            self._count("kv_relief_blocks", freed)
            self._count("prefix_evictions")
        return freed

    def _decode_with_relief(self, generator, events: List[ServeEvent]):
        """Run the decode chunk, relieving KV-pool OOM pressure in
        escalation order: prefix-cache eviction first (evict-to-pool),
        then -- only when the cache has nothing left to give -- evict
        the YOUNGEST live sequence with an explicit ``rejected
        (reason=kv_oom)`` terminal (harvest-reject). Each loop
        iteration frees blocks or removes a sequence, so it
        terminates."""
        from realhf_tpu_torch.engine.kv_pool import KVPoolOOM
        while True:
            try:
                self.backend.decode_chunk(generator)
                return
            except KVPoolOOM as e:
                if self._relieve_pool(max(1, e.shortfall)):
                    continue
                if not self._active:
                    return
                int_id = max(self._active)
                seq = self._active[int_id]
                self._evict(int_id)
                self._count("kv_oom_evictions")
                logger.warning(
                    "KV pool exhausted mid-decode and the prefix "
                    "cache is dry; evicted youngest sequence %s.",
                    seq.req.rid)
                events.append(ServeEvent(
                    protocol.REJECTED, seq.req.rid,
                    dict(reason=protocol.REASON_KV_OOM,
                         retry_after=None)))

    def _update_pool_gauges(self):
        """Surface the pool as gauges of the metrics registry:
        bytes in use, free blocks, and the internal fragmentation
        ratio (1 - live rows / rows the in-use blocks could hold,
        counting both tenants' rows)."""
        stats_fn = getattr(self.backend, "kv_pool_stats", None)
        if stats_fn is None \
                or getattr(self.backend, "kv_pool", None) is None:
            return
        s = stats_fn()
        rows = s.get("rows_in_use", 0)
        if self._pooled and self._prefix_capable:
            rows += getattr(self.prefix_cache, "rows", 0)
        cap_rows = s["blocks_in_use"] * s["block_len"]
        frag = 1.0 - rows / cap_rows if cap_rows else 0.0
        frag = min(1.0, max(0.0, frag))
        obs_metrics.set_gauge("serving_kv_pool_bytes_in_use",
                              s["bytes_in_use"])
        obs_metrics.set_gauge("serving_kv_pool_blocks_free",
                              s["blocks_free"])
        obs_metrics.set_gauge("serving_kv_pool_frag_ratio", frag)
        self.last_pool_stats = dict(s, frag_ratio=round(frag, 4))

    # ------------------------------------------------------------------
    def _fill_slot(self, slot: int, int_id: int, req: GenRequest):
        """Prefill a request into a slot, consulting the radix prefix
        cache first: on a hit, the donor seeds the slot (pooled: the
        cached blocks are ALIASED into the slot's block table; host:
        the donor KV is copied in) and only the uncached suffix runs
        the forward. The donor pin lives for exactly the match->fill
        window."""
        if not self._prefix_capable:
            self.backend.fill_slot(slot, int_id, req.prompt)
            return
        # the model still needs >= 1 real token to produce the hidden
        # state feeding the first decode step
        m = self.prefix_cache.match(req.prompt,
                                    max_len=len(req.prompt) - 1)
        try:
            if m.cached_len > 0:
                self._count("prefix_hits")
                self._count("prefix_tokens_saved", m.cached_len)
                if self._pooled:
                    self.backend.fill_slot(
                        slot, int_id, req.prompt,
                        cached_len=m.cached_len,
                        cached_blocks=list(m.blocks))
                else:
                    self.backend.fill_slot(slot, int_id, req.prompt,
                                           cached_len=m.cached_len,
                                           prefix_kv=(m.k, m.v))
            else:
                self._count("prefix_misses")
                self.backend.fill_slot(slot, int_id, req.prompt)
        finally:
            self.prefix_cache.release(m.handle)

    def _publish_kv(self, seq: _ActiveSeq, fs, version: int):
        """Credit a finished sequence's KV back to the prefix cache.
        Skipped when the sequence lived through a weight swap: its
        rows mix weight versions and must not seed future requests.
        Pooled flow: ``fs.blocks`` carry receiver-owned pool refs --
        the cache increfs what it keeps, then the refs are ALWAYS
        freed here, publication or not."""
        if self._pooled:
            blocks = getattr(fs, "blocks", None)
            if not self._prefix_capable or blocks is None:
                return
            try:
                if seq.version_start == version:
                    ev0 = self.prefix_cache.stats["evictions"]
                    self.prefix_cache.insert(
                        np.concatenate(
                            [np.asarray(seq.req.prompt, np.int64),
                             np.asarray(fs.tokens, np.int64)]),
                        blocks=blocks)
                    ev = self.prefix_cache.stats["evictions"] - ev0
                    if ev:
                        self._count("prefix_evictions", ev)
            finally:
                self.backend.kv_pool.free(blocks)
            obs_metrics.set_gauge("serving_prefix_bytes",
                                  self.prefix_cache.bytes_used)
            return
        if (not self._prefix_capable or getattr(fs, "kv", None) is None
                or seq.version_start != version):
            return
        ev0 = self.prefix_cache.stats["evictions"]
        self.prefix_cache.insert(
            np.concatenate([np.asarray(seq.req.prompt, np.int64),
                            np.asarray(fs.tokens, np.int64)]),
            fs.kv[0], fs.kv[1])
        ev = self.prefix_cache.stats["evictions"] - ev0
        if ev:
            self._count("prefix_evictions", ev)
        obs_metrics.set_gauge("serving_prefix_bytes",
                              self.prefix_cache.bytes_used)

    # ------------------------------------------------------------------
    def _snapshot_active(self) -> Dict[int, tuple]:
        """slot -> (tokens, logprobs) for every live slot; one bundled
        transfer via the backend's ``snapshot_slots`` when it has one
        (test fakes may only provide the per-slot form)."""
        slots = [seq.slot for seq in self._active.values()]
        batched = getattr(self.backend, "snapshot_slots", None)
        if batched is not None:
            return batched(slots)
        return {s: self.backend.snapshot_slot(s) for s in slots}

    def _is_stale(self, seq: _ActiveSeq, version: int) -> bool:
        return (self.max_staleness is not None
                and version - seq.version_start > self.max_staleness)

    def _stale_info(self, seq: _ActiveSeq, version: int) -> dict:
        return dict(weight_version=seq.version_start,
                    current_version=version,
                    max_staleness=self.max_staleness)
