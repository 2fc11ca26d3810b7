"""Environment-in-the-loop agentic RL.

A token-level :class:`Env` protocol and registry (a verifiable-reward
checker task and a multi-turn tool-call game), an
:class:`EpisodeRunner` driving concurrent episodes through the
rollout-client protocol (here the in-process
:class:`LocalRolloutBackend`), and trajectory-structured
``SequenceSample`` assembly feeding the PPO interfaces unchanged.
Importing this package registers the ``agentic_actor`` interface and
the envs."""

from realhf_tpu_torch.agentic.env import (  # noqa: F401
    ALL_ENV_CLASSES,
    CheckerEnv,
    Env,
    EnvStep,
    ToolGameEnv,
    make_env,
    register_env,
)
from realhf_tpu_torch.agentic.episode import (  # noqa: F401
    Episode,
    EpisodeRunner,
    Turn,
)
from realhf_tpu_torch.agentic.local import (  # noqa: F401
    GenResult,
    LocalRolloutBackend,
    engine_generate_fn,
)
from realhf_tpu_torch.agentic.trajectory import (  # noqa: F401
    episode_to_trajectory,
    episodes_to_sample,
    turn_segments,
)

import realhf_tpu_torch.agentic.interface  # noqa: F401,E402 (registers)
