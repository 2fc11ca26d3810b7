"""Experiment specification: the models (role -> spec), the dataflow
graph of MFCs, the dataset and run control."""

import dataclasses
from typing import Dict, List, Optional

from realhf_tpu_torch.api.config import DatasetAbstraction
from realhf_tpu_torch.api.dfg import MFCDef
from realhf_tpu_torch.engine.optim import OptimizerConfig
from realhf_tpu_torch.parallel.mesh import ParallelismConfig

__all__ = ["ExperimentSpec", "MFCAllocation", "ModelSpec",
           "ParallelismConfig", "SaveEvalControl", "ServingSpec"]


@dataclasses.dataclass
class ModelSpec:
    """One model role."""
    #: the HF family of the checkpoint at ``path`` and of saves
    hf_family: str = "llama"
    path: Optional[str] = None  # HF checkpoint dir; None = random init
    # used when path is None (tests, benchmarks, smoke runs)
    random_init_config: Optional[dict] = None
    is_critic: bool = False
    #: a critic from an actor's checkpoint: the LM head dropped, a fresh
    #: value head drawn as the JAX package draws it
    init_critic_from_actor: bool = False
    #: the optimizer of a trained role; None = inference only
    optimizer: Optional[OptimizerConfig] = None
    parallel: ParallelismConfig = dataclasses.field(
        default_factory=ParallelismConfig)
    gradient_checkpointing: bool = True
    bf16: bool = True
    #: restore the optimizer state saved beside ``path``; the resume path
    #: sets it, a new run from a checkpoint starts with a fresh one
    restore_optimizer_state: bool = False
    #: free the decode view's weights after each generate MFC of a
    #: pipeline, context-parallel or ``g`` layout (the next rollout moves
    #: them in again): one copy of the weights between rollouts
    drop_decode_view_after_rollout: bool = False


@dataclasses.dataclass
class MFCAllocation:
    """Per-MFC placement: a layout of the MFC's own and, optionally, the
    indices of its devices among the runner's.

    An MFC whose layout differs from its role's runs on a replica of the
    role's weights, kept fresh by parameter reallocation
    (``system/model_host.py``). ``device_ids`` index the runner's
    devices (``InlineRunner(..., devices=)``, default every card, or the
    CPU); None places the replica as ``ModelHost`` says. ``workers``
    (another process group) raises: cross-group reallocation comes with
    the distributed runtime, ROADMAP.md, queue 1, item 5."""
    parallel: ParallelismConfig
    workers: Optional[List[int]] = None
    device_ids: Optional[List[int]] = None

    def __post_init__(self):
        if self.workers is not None:
            raise NotImplementedError(
                "MFCAllocation.workers: an MFC on another worker group "
                "(cross-group reallocation over the host data plane) comes "
                "with the distributed runtime, ROADMAP.md, queue 1, item 5.")


@dataclasses.dataclass
class SaveEvalControl:
    """When the runner saves and evaluates trained roles (None = never)
    and when it stops early. The runner also saves once at the end."""
    save_freq_epochs: Optional[int] = None
    save_freq_steps: Optional[int] = None
    save_freq_secs: Optional[float] = None
    eval_freq_epochs: Optional[int] = None
    eval_freq_steps: Optional[int] = None
    benchmark_steps: Optional[int] = None  # stop early after N steps


@dataclasses.dataclass
class ServingSpec:
    """The serving engine of one rollout server: the continuous
    scheduler (``serving/scheduler.py``) over an inflight generator
    (``engine/inflight.py``), composed by ``serving/server.py``
    ``build_server``. The process, fleet, router, gateway and
    autoscaling settings come with the distributed-runtime slice of the
    port, which launches servers."""
    #: decode slots per server (concurrent sequences in the batch)
    n_slots: int = 4
    #: decode steps per host<->device sync
    chunk_size: int = 8
    max_prompt_len: int = 512
    #: admission control: queue entries beyond this are rejected with
    #: a retry_after hint (backpressure) instead of growing unbounded
    max_queue_depth: int = 256
    #: reject/evict sequences whose start weight version lags the
    #: installed version by more than this; None disables the bound
    max_staleness: Optional[int] = None
    eos_token_id: Optional[int] = None
    pad_token_id: int = 0
    #: GenerationHyperparameters kwargs (max_new_tokens, greedy, ...);
    #: force_no_logits_mask is always set -- inflight serving never
    #: produces the PPO logits mask
    gconfig: dict = dataclasses.field(default_factory=dict)
    #: send incremental token deltas after every decode chunk
    stream_tokens: bool = True
    # -- paged KV pool:
    # replace the dense per-slot [cache_len] KV windows with one
    # block-granular device pool (engine/kv_pool.py) shared with the
    # radix prefix cache. Decode memory then tracks ACTUAL tokens, so
    # concurrency is bounded by blocks, not worst-case windows, and
    # admission backpressure rides pool free blocks.
    paged_kv: bool = False
    #: KV storage dtype: None = the model's compute dtype for a dense
    #: cache, "fp32" for the pool; "fp32"/"bf16" set the storage dtype;
    #: "int8" stores quantized rows + per-row scales (implies paged_kv --
    #: dequant-on-read lives in the pool gather path).
    kv_cache_dtype: Optional[str] = None
    #: tokens per pool block (the allocation granule; internal
    #: fragmentation is < 1 block per sequence)
    kv_block_len: int = 16
    #: total pool blocks; None sizes the pool at dense parity
    #: (n_slots * ceil(cache_len / kv_block_len)) -- shrink it to
    #: trade worst-case headroom for more decode slots per byte
    kv_pool_blocks: Optional[int] = None
    #: byte budget for the radix prefix/KV cache (host memory, or pool
    #: blocks when paged): requests sharing a cached prefix skip its
    #: prefill and only run the uncached suffix. 0 disables reuse.
    prefix_cache_bytes: int = 64 * 1024 * 1024
    #: prompt-lookup speculative decoding: draft k tokens per round
    #: from the request's own history and verify them in one forward
    #: (greedy-exact; ignored unless gconfig is greedy). 0 disables.
    spec_decode_k: int = 0


@dataclasses.dataclass
class ExperimentSpec:
    experiment_name: str
    trial_name: str
    models: Dict[str, ModelSpec]
    mfcs: List[MFCDef]
    dataset: DatasetAbstraction
    #: per-MFC placement (MFC name -> a ParallelismConfig or an
    #: MFCAllocation): an MFC whose layout differs from its role's runs
    #: on a weight replica kept fresh by parameter reallocation
    allocations: Dict[str, object] = dataclasses.field(default_factory=dict)
    eval_dataset: Optional[DatasetAbstraction] = None
    tokenizer_path: Optional[str] = None
    tokenizer: Optional[object] = None  # direct object (tests, smoke runs)
    total_train_epochs: int = 1
    seed: int = 1
    ctl: SaveEvalControl = dataclasses.field(default_factory=SaveEvalControl)
    #: roles that no MFC trains (ref, reward) move their weights to the
    #: host after their last MFC of a step, freeing device memory for
    #: the train MFCs, and reload before their next use
    auto_offload: bool = False
    #: a rollout/serving deployment (``experiments/serve_exp.py``);
    #: None for training trials
    serving: Optional[ServingSpec] = None

    def alloc_of(self, node_name: str) -> Optional[MFCAllocation]:
        """The MFC's allocation as an MFCAllocation (a bare
        ParallelismConfig is wrapped), or None."""
        v = self.allocations.get(node_name)
        if v is None or isinstance(v, MFCAllocation):
            return v
        return MFCAllocation(parallel=v)
