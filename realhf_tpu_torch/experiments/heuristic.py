"""Heuristic per-MFC allocation (``allocation_mode=heuristic``).

The JAX package's ``experiments/heuristic.py`` on the port's configs:
given the device count and each role's model size, choose a decoupled
layout per MFC without a search, by the same rules:

- **train MFCs** run on the role's primary layout: t just large enough
  that bf16 weights and the ZeRO-1 optimizer state (fp32 master, Adam
  moments and gradient sums, split over d) fit one card's budget, every
  other device to d. Past ``TP_CAP`` model members the layers go over
  pipeline stages as well (with their activations counted when the
  batch's tokens are known). A layout with t > 1 turns on sequence
  parallelism.
- **generate MFCs** take the least t whose bf16 weights (with KV-cache
  headroom) fit, every other device to d.
- **inference MFCs** size t to fit bf16 weights, the rest to d, with
  stages past ``TP_CAP``.

Sizes come from ``TransformerConfig.n_params()``. The result is
{mfc_name: ParallelismConfig} plus each role's primary layout; the
quickstart applies it to the built spec (``apply_heuristic_allocations``).
"""

import dataclasses
import json
import os
from typing import Dict, List, Optional, Tuple

from realhf_tpu_torch.api.config import ModelInterfaceType
from realhf_tpu_torch.base import logging as _logging
from realhf_tpu_torch.models.config import TransformerConfig
from realhf_tpu_torch.parallel.mesh import ParallelismConfig

logger = _logging.getLogger("heuristic")

# Per-card budget in bytes: an H100 SXM's 80 GB of HBM3 with the JAX
# package's 0.6 headroom (activations and workspace take the rest).
DEFAULT_HBM_BUDGET = int(80e9 * 0.6)

# Model members beyond one NVLink domain's eight cards scale poorly
# (every layer's collectives cross the slower fabric); past this the
# heuristic prefers pipeline stages, which pass one activation a tick.
TP_CAP = 8


def _model_config_of(spec) -> TransformerConfig:
    """A model spec's config without loading weights (sizes only)."""
    if spec.random_init_config is not None:
        return TransformerConfig(**spec.random_init_config,
                                 is_critic=spec.is_critic)
    from realhf_tpu_torch.models.hf.registry import (
        config_from_hf,
        detect_family,
    )
    family = spec.hf_family or detect_family(spec.path)
    with open(os.path.join(spec.path, "config.json")) as f:
        hf_config = json.load(f)
    return config_from_hf(family, hf_config, is_critic=spec.is_critic)


def _pow2_up_to(n: int) -> List[int]:
    out, p = [], 1
    while p <= n:
        out.append(p)
        p *= 2
    return out


def _min_tp(param_bytes: float, n_devices: int, hbm_budget: int) -> int:
    for tp in _pow2_up_to(n_devices):
        if param_bytes / tp <= hbm_budget:
            return tp
    return n_devices


def train_state_bytes_per_chip(n_params: int, tp: int, pp: int,
                               dp: int) -> float:
    """Training-state bytes per device with bf16 weights and ZeRO-1: the
    bf16 weights (2 B a parameter) split over t and p; the fp32 master
    copy, Adam's two moments and the fp32 gradient sums (16 B) split
    over d as well (``engine/optim.py``, ``models/sharding.py``
    ``zero1_moment_spec``)."""
    return n_params * (2.0 + 16.0 / max(dp, 1)) / (tp * pp)


def pipeline_activation_bytes(hidden_dim: int, tokens_per_dp_rank: float,
                              n_stages: int,
                              n_microbatches: Optional[int] = None
                              ) -> float:
    """Pipeline activation bytes a stage keeps under tick remat
    (``pipeline_remat="tick"``): each of the T = M + S - 1 ticks'
    boundary activation (input and output, bf16) of one microbatch's
    tokens, whatever the depth (``parallel/pipeline.py``)."""
    m = n_microbatches or 2 * n_stages
    t = m + n_stages - 1
    return 2.0 * t * (tokens_per_dp_rank / m) * hidden_dim * 2.0


def choose_layout(cfg: TransformerConfig, n_devices: int,
                  interface_type: ModelInterfaceType,
                  trainable: bool,
                  hbm_budget: int = DEFAULT_HBM_BUDGET,
                  tokens_per_batch: Optional[float] = None
                  ) -> ParallelismConfig:
    """One MFC's layout on ``n_devices`` devices. ``tokens_per_batch``
    (train batch sequences x length, when known) makes the trainable
    fit check count pipeline activations beside the weights."""
    n_params = cfg.n_params()

    if trainable:
        # ZeRO-1: the moments shrink with d, so the fit check takes the
        # d each (t, p) candidate leaves
        def fits(tp, pp):
            dp = max(1, n_devices // (tp * pp))
            need = train_state_bytes_per_chip(n_params, tp, pp, dp)
            if pp > 1 and tokens_per_batch is not None:
                need += pipeline_activation_bytes(
                    cfg.hidden_dim, tokens_per_batch / dp, pp)
            return need <= hbm_budget

        tp = next((t for t in _pow2_up_to(n_devices) if fits(t, 1)),
                  n_devices)
        pp = 1
        if tp > TP_CAP:
            # very large models: t held at TP_CAP, the layers over
            # pipeline stages
            tp = min(TP_CAP, n_devices)
            for cand in _pow2_up_to(max(1, n_devices // tp)):
                pp = cand
                if cfg.n_layers % cand == 0 and fits(tp, cand):
                    break
            while pp > 1 and cfg.n_layers % pp != 0:
                pp //= 2
        dp = max(1, n_devices // (tp * pp))
        per_chip = train_state_bytes_per_chip(n_params, tp, pp, dp)
        if pp > 1 and tokens_per_batch is not None:
            per_chip += pipeline_activation_bytes(
                cfg.hidden_dim, tokens_per_batch / dp, pp)
        if per_chip > hbm_budget:
            logger.warning(
                "Heuristic layout t%dp%d leaves %.1f GB/device for a "
                "%.1f GB budget (n_layers=%d limits pipeline depth); "
                "expect OOM without remat/offload headroom or more "
                "devices.", tp, pp, per_chip / 1e9, hbm_budget / 1e9,
                cfg.n_layers)
        return ParallelismConfig(
            data_parallel_size=dp, tensor_parallel_size=tp,
            pipeline_parallel_size=pp, sequence_parallel=tp > 1)

    if interface_type == ModelInterfaceType.GENERATE:
        # bf16 weights + KV cache headroom
        bytes_needed = n_params * 2 * 1.5
    else:
        bytes_needed = n_params * 2 * 1.2
    tp = _min_tp(bytes_needed, n_devices, hbm_budget)
    pp = 1
    if tp > TP_CAP and interface_type != ModelInterfaceType.GENERATE:
        tp = min(TP_CAP, n_devices)
        for cand in _pow2_up_to(max(1, n_devices // tp)):
            pp = cand
            if (cfg.n_layers % cand == 0
                    and bytes_needed / (tp * cand) <= hbm_budget):
                break
        while pp > 1 and cfg.n_layers % pp != 0:
            pp //= 2
    if bytes_needed / (tp * pp) > hbm_budget:
        logger.warning(
            "Heuristic layout t%dp%d leaves %.1f GB/device for a %.1f GB "
            "budget (n_layers=%d limits pipeline depth); expect OOM "
            "without remat/offload headroom or more devices.",
            tp, pp, bytes_needed / (tp * pp) / 1e9, hbm_budget / 1e9,
            cfg.n_layers)
    dp = max(1, n_devices // (tp * pp))
    return ParallelismConfig(
        data_parallel_size=dp, tensor_parallel_size=tp,
        pipeline_parallel_size=pp, sequence_parallel=False)


def heuristic_allocations(
    spec, n_devices: int, hbm_budget: int = DEFAULT_HBM_BUDGET,
) -> Tuple[Dict[str, ParallelismConfig], Dict[str, ParallelismConfig]]:
    """(each role's primary layout, per-MFC overrides) of an
    ``ExperimentSpec`` on ``n_devices`` devices.

    A role's primary layout is its train MFC's when it has one (replicas
    hold no optimizer), else its widest-t MFC's. An MFC's override is
    emitted only where it differs from its role's primary (each one is a
    weight replica kept fresh by reallocation)."""
    cfgs = {role: _model_config_of(ms) for role, ms in spec.models.items()}

    # the tokens of a train batch, for the pipeline activations: the
    # dataset's max_length bounds the prompt, and a train MFC of RLHF
    # also takes the most tokens any generate MFC may add
    max_len = (spec.dataset.args or {}).get("max_length") \
        if getattr(spec, "dataset", None) is not None else None
    gen_extra = 0
    for n in spec.mfcs:
        g = (n.interface_impl.args or {}).get("gconfig")
        if isinstance(g, dict):
            gen_extra = max(gen_extra, int(g.get("max_new_tokens", 0)))
    seq_est = (max_len + gen_extra) if max_len else None

    mfc_layouts: Dict[str, ParallelismConfig] = {}
    for node in spec.mfcs:
        trainable = node.interface_type == ModelInterfaceType.TRAIN_STEP
        tokens = node.n_seqs * seq_est if trainable and seq_est else None
        mfc_layouts[node.name] = choose_layout(
            cfgs[node.role], n_devices, node.interface_type,
            trainable, hbm_budget, tokens_per_batch=tokens)

    primaries: Dict[str, ParallelismConfig] = {}
    for role in spec.models:
        role_nodes = [n for n in spec.mfcs if n.role == role]
        train = [n for n in role_nodes
                 if n.interface_type == ModelInterfaceType.TRAIN_STEP]
        if train:
            primaries[role] = mfc_layouts[train[0].name]
        elif role_nodes:
            primaries[role] = max(
                (mfc_layouts[n.name] for n in role_nodes),
                key=lambda p: p.tensor_parallel_size)
        else:
            primaries[role] = ParallelismConfig(data_parallel_size=n_devices)

    overrides = {
        n.name: mfc_layouts[n.name] for n in spec.mfcs
        if not mfc_layouts[n.name].same_layout(primaries[n.role])
    }
    return primaries, overrides


def apply_heuristic_allocations(spec, n_devices: int,
                                hbm_budget: int = DEFAULT_HBM_BUDGET):
    """Set each role's primary layout and the per-MFC overrides on an
    ``ExperimentSpec`` in place; returns it."""
    primaries, overrides = heuristic_allocations(spec, n_devices,
                                                 hbm_budget)
    for role, par in primaries.items():
        spec.models[role] = dataclasses.replace(spec.models[role],
                                                parallel=par)
    spec.allocations = dict(spec.allocations)
    spec.allocations.update(overrides)
    return spec
