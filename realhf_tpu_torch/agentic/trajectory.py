"""Trajectory-structured SequenceSample assembly.

An episode flattens to one packed sequence, observations and actions
interleaved in turn order, so multi-turn data flows through the PPO
interfaces unchanged. The encoding:

- ``packed_input_ids``: ``obs_1 + act_1 + obs_2 + act_2 + ...``
- ``prompt_mask`` (full length): True on every token the policy did not
  emit (the prompt and every env/tool observation), so PPO's shifted
  loss mask (``~prompt_mask[1:]`` per sequence) leaves observations out
  of the policy loss.
- ``packed_logprobs`` (length l - 1): behavior log-probs on the action
  prediction slots, zeros elsewhere (an action token at index ``j`` is
  predicted at shifted slot ``j - 1``).
- ``dense_rewards`` (length l - 1): each turn's reward at its last
  action token's prediction slot, zeros elsewhere, read by the
  ``turn_level_credit`` knob; ``rewards`` holds the episode total.
- metadata: per-sample ``weight_version`` (the minimum over turns),
  ``staleness``, ``n_turns`` and ``turn_spans`` of ``(start, n_obs,
  n_action, weight_version)``.
"""

from typing import List, Optional, Tuple

import numpy as np

from realhf_tpu_torch.agentic.episode import KEEP_STATUSES, Episode
from realhf_tpu_torch.api.data import SequenceSample
from realhf_tpu_torch.system.rollout import (
    Trajectory,
    trajectories_to_sample,
)


def episode_to_trajectory(ep: Episode, *, trainer_version: int = 0
                          ) -> Trajectory:
    """Flatten one finished episode into a multi-turn
    :class:`~realhf_tpu_torch.system.rollout.Trajectory` (consumed by the
    shared ``trajectories_to_sample`` packer)."""
    if not ep.turns:
        raise ValueError(f"episode {ep.sid} has no turns")
    if ep.status not in KEEP_STATUSES:
        raise ValueError(
            f"episode {ep.sid} has status {ep.status!r}; only "
            f"{KEEP_STATUSES} flatten to trajectories")
    tokens, pmask = [], []
    spans: List[Tuple[int, int, int, int]] = []
    start = 0
    for t in ep.turns:
        n_obs, n_act = len(t.obs), len(t.action)
        if n_act < 1:
            raise ValueError(
                f"episode {ep.sid}: a turn has an empty action")
        tokens.append(np.asarray(t.obs, np.int32))
        tokens.append(np.asarray(t.action, np.int32))
        pmask.append(np.ones(n_obs, bool))
        pmask.append(np.zeros(n_act, bool))
        spans.append((start, n_obs, n_act, int(t.weight_version)))
        start += n_obs + n_act
    flat = np.concatenate(tokens)
    pmask = np.concatenate(pmask)
    l = len(flat)
    if len(ep.turns[0].obs) < 1:
        raise ValueError(
            f"episode {ep.sid}: first observation is empty -- the "
            "first prediction slot needs at least one prompt token")
    logprobs = np.zeros(l - 1, np.float32)
    dense = np.zeros(l - 1, np.float32)
    for (s, n_obs, n_act, _wv), t in zip(spans, ep.turns):
        a0 = s + n_obs          # absolute index of first action token
        logprobs[a0 - 1:a0 - 1 + n_act] = \
            np.asarray(t.logprobs, np.float32)[:n_act]
        # reward at the turn's LAST action token's prediction slot
        # (abs index a0+n_act-1, shifted slot a0+n_act-2; >= 0 because
        # the first observation is non-empty and actions are non-empty)
        dense[a0 + n_act - 2] += np.float32(t.reward)
    versions = [int(t.weight_version) for t in ep.turns]
    wv = min(versions)
    prompt = flat[:spans[0][1]]
    return Trajectory(
        sid=ep.sid, prompt=prompt, tokens=flat[len(prompt):],
        logprobs=logprobs,
        no_eos=bool(ep.turns[-1].no_eos or ep.status != "done"),
        weight_version=wv,
        staleness=max(0, int(trainer_version) - wv),
        prompt_mask=pmask, dense_rewards=dense,
        reward=ep.total_reward, turns=spans)


def episodes_to_sample(episodes: List[Episode], *,
                       trainer_version: int = 0,
                       ids: Optional[list] = None) -> SequenceSample:
    """Pack finished episodes into one trajectory-structured batch via
    the shared packer. ``ids`` (optional) reorders the episodes to
    match an input batch's id order (the AgenticActorInterface returns
    samples in ``input_.ids`` order)."""
    if ids is not None:
        by_sid = {ep.sid: ep for ep in episodes}
        missing = [i for i in ids if i not in by_sid]
        if missing:
            raise ValueError(
                f"episodes missing for ids {missing[:8]} "
                f"({len(missing)} of {len(ids)}); dropped episodes "
                "cannot flow into a fixed-id batch")
        episodes = [by_sid[i] for i in ids]
    return trajectories_to_sample(
        [episode_to_trajectory(ep, trainer_version=trainer_version)
         for ep in episodes])


def turn_segments(sample: SequenceSample, i: int
                  ) -> List[Tuple[int, int, int, int]]:
    """The i-th sample's per-turn ``(start, n_obs, n_action,
    weight_version)`` spans."""
    return list(sample.metadata["turn_spans"][i])
