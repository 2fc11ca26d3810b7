"""Interface registrations."""

from realhf_tpu_torch.interfaces import (  # noqa: F401
    dpo,
    gen,
    grpo,
    ppo,
    reinforce,
    rw,
    sft,
)

import realhf_tpu_torch.agentic  # noqa: F401,E402 (agentic_actor)
