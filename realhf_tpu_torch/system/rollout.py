"""Finished rollouts as training consumes them, and their packing into
the actor-gen batch layout.

The controller that keeps a serving fleet saturated while training
consumes its trajectories comes with the distributed-runtime slice of
the port; the agentic episode loop already packs its episodes here.
"""

import dataclasses
from typing import Hashable, List, Optional

import numpy as np

from realhf_tpu_torch.api.data import SequenceSample


@dataclasses.dataclass
class Trajectory:
    """One finished rollout, as training consumes it."""
    sid: Hashable
    prompt: np.ndarray
    tokens: np.ndarray
    logprobs: np.ndarray
    no_eos: bool
    #: weight version installed when generation started (the behavior
    #: policy label the PPO staleness correction keys on)
    weight_version: int
    #: trainer_version - weight_version at harvest time
    staleness: int
    # -- multi-turn (agentic) trajectories. When ``prompt_mask`` is set,
    # ``prompt`` holds only the first observation, ``tokens`` the
    # remaining turns (actions and env/tool observations interleaved),
    # and ``logprobs`` is the full shifted (l - 1) array, zeros on
    # non-action slots.
    #: full-length (l) bool mask: True on tokens the policy did NOT emit
    #: (initial prompt and env/tool observations), so PPO's shifted loss
    #: mask leaves observation tokens out unchanged
    prompt_mask: Optional[np.ndarray] = None
    #: shifted (l - 1) per-position rewards: each turn's reward at its
    #: last action token's prediction slot, zeros elsewhere
    dense_rewards: Optional[np.ndarray] = None
    #: scalar episode reward (sum of turn rewards)
    reward: Optional[float] = None
    #: per-turn (start, n_obs, n_action, weight_version) spans over the
    #: flattened sequence, in turn order
    turns: Optional[List[tuple]] = None


def trajectories_to_sample(trajs: List[Trajectory]) -> SequenceSample:
    """Pack trajectories into the actor-gen output layout (as
    ``PPOActorInterface.generate`` makes it): per sequence
    ``packed_input_ids`` = prompt + generated tokens, ``packed_logprobs``
    (length l - 1, zeros over the prompt) the behavior policy's
    log-probs, ``prompt_mask`` the prompt span, ``seq_no_eos_mask`` the
    truncated sequences, and ``metadata['weight_version']`` /
    ``['staleness']`` per sample.

    Multi-turn trajectories pack through the same layout and add
    ``rewards`` (the episode reward: agentic graphs have no reward
    model), ``dense_rewards`` (shifted per-position turn rewards, for
    ``turn_level_credit``) and per-sample ``n_turns`` / ``turn_spans``
    metadata. Single- and multi-turn trajectories cannot share a batch
    (their keys differ)."""
    if not trajs:
        raise ValueError("no trajectories to pack")
    agentic = trajs[0].prompt_mask is not None
    if any((t.prompt_mask is not None) != agentic for t in trajs):
        raise ValueError(
            "cannot pack single-turn and multi-turn trajectories into "
            "one batch: their data keys differ")
    seqlens, ids, in_ids, logprobs, prompt_mask = [], [], [], [], []
    no_eos, versions, staleness = [], [], []
    rewards, dense, n_turns, turn_spans = [], [], [], []
    for t in trajs:
        g = len(t.tokens)
        l = len(t.prompt) + g
        seqlens.append(l)
        ids.append(t.sid)
        in_ids.append(np.concatenate(
            [np.asarray(t.prompt, np.int32),
             np.asarray(t.tokens, np.int32)]))
        if agentic:
            lp = np.asarray(t.logprobs, np.float32)
            pm = np.asarray(t.prompt_mask, bool)
            dr = np.asarray(t.dense_rewards, np.float32)
            if len(lp) != l - 1 or len(pm) != l or len(dr) != l - 1:
                raise ValueError(
                    f"trajectory {t.sid}: multi-turn arrays must be "
                    f"full-length (l={l}): logprobs {len(lp)} "
                    f"(want {l - 1}), prompt_mask {len(pm)} (want {l}),"
                    f" dense_rewards {len(dr)} (want {l - 1})")
            logprobs.append(lp)
            prompt_mask.append(pm)
            dense.append(dr)
            rewards.append(np.float32(t.reward if t.reward is not None
                                      else dr.sum()))
            n_turns.append(len(t.turns or ()))
            turn_spans.append(list(t.turns or ()))
        else:
            lp = np.zeros(l - 1, np.float32)
            lp[len(t.prompt) - 1:] = np.asarray(t.logprobs,
                                                np.float32)[:g]
            logprobs.append(lp)
            prompt_mask.append(np.concatenate(
                [np.ones(len(t.prompt), bool), np.zeros(g, bool)]))
        no_eos.append(bool(t.no_eos))
        versions.append(int(t.weight_version))
        staleness.append(int(t.staleness))
    data = dict(
        seq_no_eos_mask=np.asarray(no_eos),
        packed_input_ids=np.concatenate(in_ids).astype(np.int32),
        packed_logprobs=np.concatenate(logprobs).astype(np.float32),
        prompt_mask=np.concatenate(prompt_mask),
    )
    metadata = dict(weight_version=versions, staleness=staleness)
    if agentic:
        data["rewards"] = np.asarray(rewards, np.float32)
        data["dense_rewards"] = np.concatenate(dense).astype(np.float32)
        metadata["n_turns"] = n_turns
        metadata["turn_spans"] = turn_spans
    return SequenceSample.from_default(
        ids=ids, seqlens=seqlens, data=data, metadata=metadata)
