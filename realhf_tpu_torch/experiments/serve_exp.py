"""Serving experiment: a standalone continuous-batching rollout
service over one model role, no dataflow graph.

``ServeConfig.build()`` returns an ``ExperimentSpec`` whose ``serving``
field (``api/experiment.py`` ``ServingSpec``) configures the engine:
``serving/scheduler.py`` ``ContinuousScheduler`` over
``engine/inflight.py`` ``InflightBatchingGenerator``, with the paged /
int8 KV pool, the radix prefix cache and speculative decoding.
``serving/server.py`` ``build_server`` composes that engine over a
model, in process; launching the service as server processes that
answer remote clients (``quickstart serve``) needs the rollout
transport of the distributed-runtime slice of the port and raises
until then.
"""

import dataclasses
from typing import Optional

from realhf_tpu_torch.api.experiment import ExperimentSpec, ServingSpec
from realhf_tpu_torch.experiments.common import (
    CommonExperimentConfig,
    ModelConfigCLI,
    register_experiment,
)


@dataclasses.dataclass
class ServeConfig(CommonExperimentConfig):
    model: ModelConfigCLI = dataclasses.field(
        default_factory=ModelConfigCLI)
    n_slots: int = 4
    chunk_size: int = 8
    max_prompt_len: int = 512
    max_queue_depth: int = 256
    max_staleness: Optional[int] = None
    eos_token_id: Optional[int] = None
    pad_token_id: int = 0
    stream_tokens: bool = True
    # the engine's KV substrate and hot path (ServingSpec documents
    # each field)
    paged_kv: bool = False
    kv_cache_dtype: Optional[str] = None
    kv_block_len: int = 16
    kv_pool_blocks: Optional[int] = None
    prefix_cache_bytes: int = 64 * 1024 * 1024
    spec_decode_k: int = 0
    # sampling defaults for every request
    max_new_tokens: int = 256
    min_new_tokens: int = 0
    greedy: bool = False
    top_p: float = 1.0
    top_k: int = 0
    temperature: float = 1.0

    def build(self) -> ExperimentSpec:
        serving = ServingSpec(
            n_slots=self.n_slots,
            chunk_size=self.chunk_size,
            max_prompt_len=self.max_prompt_len,
            max_queue_depth=self.max_queue_depth,
            max_staleness=self.max_staleness,
            eos_token_id=self.eos_token_id,
            pad_token_id=self.pad_token_id,
            stream_tokens=self.stream_tokens,
            paged_kv=self.paged_kv,
            kv_cache_dtype=self.kv_cache_dtype,
            kv_block_len=self.kv_block_len,
            kv_pool_blocks=self.kv_pool_blocks,
            prefix_cache_bytes=self.prefix_cache_bytes,
            spec_decode_k=self.spec_decode_k,
            gconfig=dict(
                max_new_tokens=self.max_new_tokens,
                min_new_tokens=self.min_new_tokens,
                greedy=self.greedy, top_p=self.top_p,
                top_k=self.top_k, temperature=self.temperature))
        return ExperimentSpec(
            experiment_name=self.experiment_name,
            trial_name=self.trial_name,
            models={"default": self.model.to_spec(train=False)},
            mfcs=[],
            dataset=None,
            tokenizer_path=self.tokenizer_path or self.model.path,
            seed=self.seed,
            ctl=self.ctl(),
            serving=serving)


register_experiment("serve", ServeConfig)
