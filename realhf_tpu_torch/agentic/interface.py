"""Agentic actor interface: env-in-the-loop generation as an MFC.

It takes ``actor_gen``'s place in the PPO dataflow graph: each dataset
prompt seeds an environment episode, driven by the
:class:`~realhf_tpu_torch.agentic.episode.EpisodeRunner` over the
in-process :class:`~realhf_tpu_torch.agentic.local.LocalRolloutBackend`.
The output is a trajectory-structured batch (``agentic/trajectory.py``):
observation tokens masked out of the policy loss, each turn's reward at
its boundary, the episode total under ``rewards``. The env is the
reward model, so agentic graphs have no ``rew_inf`` MFC.

``inference`` and ``train_step`` are ``PPOActorInterface``'s
(``turn_level_credit=True`` there places credit at turn boundaries in
place of the sequence's end)."""

import dataclasses
from typing import Dict, Optional

import numpy as np

from realhf_tpu_torch.agentic.env import make_env
from realhf_tpu_torch.agentic.episode import EpisodeRunner
from realhf_tpu_torch.agentic.local import (
    LocalRolloutBackend,
    engine_generate_fn,
)
from realhf_tpu_torch.agentic.trajectory import episodes_to_sample
from realhf_tpu_torch.api import model as model_api
from realhf_tpu_torch.api.data import SequenceSample
from realhf_tpu_torch.base import logging
from realhf_tpu_torch.base.datapack import flat2d
from realhf_tpu_torch.interfaces.ppo import PPOActorInterface

logger = logging.getLogger("AgenticInterface")


@dataclasses.dataclass
class AgenticActorInterface(PPOActorInterface):
    #: registered env name (``agentic/env.py``)
    env: str = "checker_task"
    #: extra env constructor kwargs; ``vocab_size`` defaults to the
    #: model's
    env_args: Dict = dataclasses.field(default_factory=dict)
    max_turns: int = 4
    #: context cap per episode (tokens); None = 4x the model's
    #: generation budget past the longest prompt
    max_context_len: Optional[int] = None
    #: concurrent episodes; 0 = the whole batch at once
    max_concurrent: int = 0

    def generate(self, model: model_api.Model, input_: SequenceSample,
                 n_mbs: Optional[int] = None) -> SequenceSample:
        prompt_lens = flat2d(input_.seqlens["packed_prompts"])
        flat = input_.data["packed_prompts"]
        prompts, off = [], 0
        for l in prompt_lens:
            prompts.append(np.asarray(flat[off:off + l], np.int32))
            off += l

        env_args = dict(self.env_args)
        env_args.setdefault("vocab_size", model.config.vocab_size)
        self._gen_calls += 1
        seed_base = self._gen_calls * 100003

        def episodes():
            for i, (sid, p) in enumerate(zip(input_.ids, prompts)):
                yield sid, make_env(self.env, prompt=p,
                                    seed=seed_base + i, **env_args)

        backend = LocalRolloutBackend(
            engine_generate_fn(model, self.gconfig),
            version_fn=lambda: model.version.global_step)
        max_ctx = self.max_context_len
        if max_ctx is None:
            max_ctx = max(prompt_lens) \
                + 4 * self.max_turns * self.gconfig.max_new_tokens
        runner = EpisodeRunner(
            backend, episodes(),
            max_concurrent=(self.max_concurrent or len(prompts)),
            max_turns=self.max_turns, max_seq_len=max_ctx)
        finished = runner.run_all()
        if runner.dropped:
            # a fixed-id batch cannot have holes: name the drops here
            # instead of failing downstream on an id mismatch
            raise RuntimeError(
                f"agentic generate dropped episodes: {runner.dropped}")
        sample = episodes_to_sample(
            finished, trainer_version=model.version.global_step,
            ids=list(input_.ids))
        st = runner.stats()
        logger.info(
            "Agentic generate (%s): %d episodes, %d turns, mean "
            "episode reward %.4f.", self.env, st["episodes_done"],
            st["turns_done"], float(np.mean(sample.data["rewards"])))
        return sample


model_api.register_interface("agentic_actor", AgenticActorInterface)
