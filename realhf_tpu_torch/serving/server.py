"""The rollout server in process: ``build_server`` composes the serving
engine of one server from its ``ServingSpec`` (``api/experiment.py``),
and ``RolloutResult`` is the terminal outcome a client sees. The
process that answers remote clients over this engine comes with the
transport of the distributed-runtime slice of the port."""

import dataclasses
import time
from typing import Callable, Optional

from realhf_tpu_torch.base.device import DeviceLike
from realhf_tpu_torch.serving import protocol


@dataclasses.dataclass
class RolloutResult:
    """Terminal outcome of one request, as seen by the client."""
    rid: str
    status: str                 # a protocol.TERMINAL_KINDS entry
    data: dict

    @property
    def ok(self) -> bool:
        return self.status == protocol.DONE


@dataclasses.dataclass
class ServingEngine:
    """What one server runs: the scheduler's ``step`` is its loop, the
    queue takes requests, ``weight_sync`` takes weight pushes."""
    generator: object           # engine/inflight.InflightBatchingGenerator
    scheduler: object           # serving/scheduler.ContinuousScheduler
    queue: object               # serving/request_queue.RequestQueue
    weight_sync: object         # serving/weight_sync.WeightSync
    kv_pool: Optional[object]   # engine/kv_pool.KVPool when paged
    prefix_cache: Optional[object]


def build_server(serving, cfg, params, *, device: DeviceLike = None,
                 clock: Callable[[], float] = time.monotonic
                 ) -> ServingEngine:
    """The engine of one server over a model's config and params, as
    the JAX package's rollout worker composes it: ``kv_cache_dtype
    "int8"`` implies the paged pool; the pool defaults to ``"fp32"``
    rows and to dense parity (``n_slots * ceil(cache_len /
    kv_block_len)`` blocks); a paged engine pairs with the pooled prefix
    cache, a dense one with the host cache, and ``prefix_cache_bytes``
    0 with none. ``device`` defaults to the card. ``params`` may be the
    ``MemberParams`` of a dNtM layout: the engine then runs over those
    members, each member's pool arena on its device; a pipeline or
    context-parallel layout raises, since a server serves its model's
    weights as they are, without a decode view."""
    from realhf_tpu_torch.engine.inflight import InflightBatchingGenerator
    from realhf_tpu_torch.engine.kv_pool import KVPool
    from realhf_tpu_torch.models import transformer as T
    from realhf_tpu_torch.models.sharding import MemberParams
    from realhf_tpu_torch.ops.sampling import GenerationHyperparameters
    from realhf_tpu_torch.serving.prefix_cache import (
        PooledPrefixCache,
        RadixPrefixCache,
    )
    from realhf_tpu_torch.serving.request_queue import RequestQueue
    from realhf_tpu_torch.serving.scheduler import ContinuousScheduler
    from realhf_tpu_torch.serving.weight_sync import WeightSync
    sv = serving
    members = {}
    if isinstance(params, MemberParams):
        if params.p > 1 or params.c > 1:
            raise ValueError(
                f"build_server over a p{params.p} c{params.c} layout: a "
                "rollout server generates on its model's weights as they "
                "are, with no decode view, as the JAX package's rollout "
                "worker does, and such weights are laid out for a pipeline "
                "or a context ring; serve the model on a dNtM layout.")
        members = dict(devices=params.devices, t=params.t)
    gconfig = GenerationHyperparameters(**dict(sv.gconfig,
                                               force_no_logits_mask=True))
    paged = sv.paged_kv or sv.kv_cache_dtype == "int8"
    kv_pool = None
    if paged:
        cache_len = T.round_cache_len(sv.max_prompt_len
                                      + gconfig.max_new_tokens)
        n_blocks = sv.kv_pool_blocks or sv.n_slots * (
            -(-cache_len // sv.kv_block_len))
        kv_pool = KVPool(cfg, n_blocks, sv.kv_block_len,
                         dtype=sv.kv_cache_dtype or "fp32", device=device,
                         **members)
    gen = InflightBatchingGenerator(
        cfg, params, gconfig, n_slots=sv.n_slots,
        max_prompt_len=sv.max_prompt_len, eos_token_id=sv.eos_token_id,
        pad_token_id=sv.pad_token_id, chunk_size=sv.chunk_size,
        spec_decode_k=sv.spec_decode_k, kv_pool=kv_pool,
        kv_cache_dtype=None if paged else sv.kv_cache_dtype, device=device)
    if sv.prefix_cache_bytes <= 0:
        cache = None
    elif kv_pool is not None:
        cache = PooledPrefixCache(kv_pool, sv.prefix_cache_bytes)
    else:
        cache = RadixPrefixCache(sv.prefix_cache_bytes)
    queue = RequestQueue(max_depth=sv.max_queue_depth, n_slots=sv.n_slots,
                         max_prompt_len=gen.max_prompt_len, clock=clock)
    ws = WeightSync()
    sched = ContinuousScheduler(gen, queue, ws,
                                max_staleness=sv.max_staleness,
                                stream_tokens=sv.stream_tokens,
                                prefix_cache=cache, clock=clock)
    return ServingEngine(generator=gen, scheduler=sched, queue=queue,
                         weight_sync=ws, kv_pool=kv_pool,
                         prefix_cache=cache)
