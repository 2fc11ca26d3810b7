"""In-process rollout backend speaking the rollout-client protocol.

The :class:`~realhf_tpu_torch.agentic.episode.EpisodeRunner` drives
episodes through whatever implements ``submit / poll_results / abandon
/ close``. :class:`LocalRolloutBackend` fulfils requests by calling a
batched ``generate_fn`` directly (no sockets, no threads, no server):
the inline runner's path, and the tests' with scripted callables.
:func:`engine_generate_fn` builds a ``generate_fn`` over a model's
engine (the AgenticActorInterface path)."""

import dataclasses
import uuid
from typing import Callable, Dict, List, Optional

import numpy as np

from realhf_tpu_torch.engine import packing
from realhf_tpu_torch.interfaces.gen import sampling_generator
from realhf_tpu_torch.serving import protocol
from realhf_tpu_torch.serving.server import RolloutResult


@dataclasses.dataclass
class GenResult:
    """One prompt's generation, as ``generate_fn`` returns it."""
    tokens: np.ndarray
    logprobs: np.ndarray
    no_eos: bool = False


class LocalRolloutBackend:
    """Batched, in-process stand-in for a rollout client.

    Submissions queue up; every ``poll_results`` call runs ONE batched
    ``generate_fn`` over everything pending (continuous batching's
    synchronous form) and returns the finished ``RolloutResult`` s
    stamped with ``version_fn()``, the weight version the batch was
    generated under."""

    def __init__(self, generate_fn: Callable[[List[np.ndarray]],
                                             List[GenResult]],
                 *, version_fn: Callable[[], int] = lambda: 0):
        self._generate_fn = generate_fn
        self._version_fn = version_fn
        self._queue: Dict[str, np.ndarray] = {}
        self.generated = 0
        self.batches = 0

    # -- rollout-client protocol ----------------------------------------
    def submit(self, prompt, priority=None, ttl=None,
               rid: Optional[str] = None,
               min_weight_version: int = 0) -> str:
        rid = rid or uuid.uuid4().hex
        self._queue[rid] = np.asarray(prompt, np.int32)
        return rid

    def abandon(self, rid: str):
        """Cancel and forget: the local queue is the only state."""
        self._queue.pop(rid, None)

    def poll_results(self, timeout: float = 0.0) -> List[RolloutResult]:
        if not self._queue:
            return []
        rids = list(self._queue)
        prompts = [self._queue.pop(r) for r in rids]
        version = int(self._version_fn())
        outs = self._generate_fn(prompts)
        if len(outs) != len(prompts):
            raise ValueError(
                f"generate_fn returned {len(outs)} results for "
                f"{len(prompts)} prompts")
        self.generated += len(outs)
        self.batches += 1
        return [
            RolloutResult(rid=rid, status=protocol.DONE, data=dict(
                tokens=np.asarray(o.tokens, np.int32),
                logprobs=np.asarray(o.logprobs, np.float32),
                no_eos=bool(o.no_eos), weight_version=version))
            for rid, o in zip(rids, outs)
        ]

    def close(self):
        self._queue.clear()


def engine_generate_fn(model, gconfig) -> Callable[[List[np.ndarray]],
                                                   List[GenResult]]:
    """A ``generate_fn`` over a model's engine: left-padded batched
    prefill and decode as in ``PPOActorInterface.generate``, each batch
    sampling from its own generator of the experiment seed (stream
    ``"agentic_generate"``, apart from the actor's ``"generate"``)."""
    tok = model.tokenizer
    calls = [0]

    def generate(prompts: List[np.ndarray]) -> List[GenResult]:
        ids, seg, pos = packing.left_padded_prompts(
            prompts, pad_id=tok.pad_token_id)
        calls[0] += 1
        out = model.engine.generate(
            ids, seg, pos,
            sampling_generator(calls[0], model.engine.device,
                               stream="agentic_generate"),
            gconfig, eos_token_id=tok.eos_token_id,
            pad_token_id=tok.pad_token_id).to_host()
        return [
            GenResult(tokens=np.asarray(out.tokens[i, :int(n)]),
                      logprobs=np.asarray(out.logprobs[i, :int(n)]),
                      no_eos=bool(out.no_eos_mask[i]))
            for i, n in enumerate(out.lengths)
        ]

    return generate
