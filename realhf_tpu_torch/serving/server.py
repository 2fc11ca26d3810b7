"""Rollout-server types a client sees. The server itself (continuous
batching, weight hot-swap) comes with the serving slice of the port;
this module holds the result record the agentic episode loop reads."""

import dataclasses

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
