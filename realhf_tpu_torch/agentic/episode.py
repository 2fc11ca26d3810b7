"""EpisodeRunner: drive N concurrent env-in-the-loop episodes.

The runner keeps up to ``max_concurrent`` episodes live against
anything that speaks the rollout-client protocol (``submit /
poll_results / abandon``): the in-process
:class:`~realhf_tpu_torch.agentic.local.LocalRolloutBackend` here, a
serving fleet's client once the serving slice lands. Per episode it
alternates

    env.reset() -> obs --submit(ctx)--> action --env.step--> obs' ...

submitting the whole context (every observation and action so far) each
turn and stamping every turn with the ``weight_version`` it was
generated under, the behavior-policy label PPO's staleness handling
reads.

Dropping an episode (env error, retry exhaustion, deadline, ``stop()``,
or max-turns with ``drop_on_max_turns``) abandons its in-flight
request, so no client state leaks."""

import dataclasses
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from realhf_tpu_torch.base import logging
from realhf_tpu_torch.obs import metrics

logger = logging.getLogger("agentic.episode", "system")

#: terminal episode statuses a trajectory can be built from
KEEP_STATUSES = ("done", "max_turns", "length")


@dataclasses.dataclass
class Turn:
    """One observation -> action exchange."""
    obs: np.ndarray        # env/tool tokens PRECEDING this action
    action: np.ndarray     # policy-emitted tokens
    logprobs: np.ndarray   # behavior logprob per action token
    reward: float          # turn-level reward for this action
    weight_version: int    # serving weight version the action decoded under
    no_eos: bool


@dataclasses.dataclass
class Episode:
    """A finished episode, in turn order."""
    sid: object
    turns: List[Turn]
    status: str            # done | max_turns | length
    info: Dict = dataclasses.field(default_factory=dict)

    @property
    def n_turns(self) -> int:
        return len(self.turns)

    @property
    def total_reward(self) -> float:
        return float(sum(t.reward for t in self.turns))


class _Live:
    __slots__ = ("sid", "env", "turns", "pending_obs", "rid",
                 "retries", "deadline")

    def __init__(self, sid, env, pending_obs, deadline):
        self.sid = sid
        self.env = env
        self.turns: List[Turn] = []
        self.pending_obs = pending_obs
        self.rid: Optional[str] = None
        self.retries = 0
        self.deadline = deadline


class EpisodeRunner:
    """Concurrent episode loop over one rollout client.

    ``episodes`` yields ``(sid, env)`` pairs; ``max_seq_len`` caps the
    context an episode may grow to (hit it and the episode finishes as
    ``"length"`` with what it has); ``episode_ttl`` bounds one
    episode's wall clock. Call ``pump()`` + ``poll()`` from your loop,
    or ``run_all()`` to drain the source."""

    def __init__(self, client,
                 episodes: Iterator[Tuple[object, object]], *,
                 max_concurrent: int = 8, max_turns: int = 8,
                 max_seq_len: Optional[int] = None,
                 ttl: Optional[float] = None,
                 episode_ttl: Optional[float] = None,
                 drop_on_max_turns: bool = False,
                 max_retries: int = 3,
                 clock: Callable[[], float] = time.monotonic):
        self.client = client
        self._source = iter(episodes)
        self.max_concurrent = max(1, int(max_concurrent))
        self.max_turns = max(1, int(max_turns))
        self.max_seq_len = max_seq_len
        self._ttl = ttl
        self._episode_ttl = episode_ttl
        self.drop_on_max_turns = drop_on_max_turns
        self.max_retries = max_retries
        self._clock = clock
        self._live: Dict[object, _Live] = {}
        self._by_rid: Dict[str, object] = {}
        self._exhausted = False
        # episodes finished by the length cap during pump() are handed
        # out on the next poll() (poll is the single completion surface)
        self._finished_overflow: List[Episode] = []
        # stats
        self.episodes_done = 0
        self.turns_done = 0
        self.env_errors = 0
        self.abandoned = 0
        self.resubmits = 0
        self.dropped: List[Tuple[object, str]] = []
        self.env_step_secs = 0.0
        #: env-step wall spent while OTHER requests were in flight (the
        #: env/generation overlap)
        self.env_step_overlap_secs = 0.0

    # ------------------------------------------------------------------
    @property
    def inflight(self) -> int:
        return len(self._by_rid)

    @property
    def live(self) -> int:
        return len(self._live)

    @property
    def exhausted(self) -> bool:
        return self._exhausted and not self._live

    # ------------------------------------------------------------------
    def _admit(self):
        while not self._exhausted and self.live < self.max_concurrent:
            try:
                sid, env = next(self._source)
            except StopIteration:
                self._exhausted = True
                return
            deadline = (None if self._episode_ttl is None
                        else self._clock() + self._episode_ttl)
            try:
                obs = np.asarray(env.reset(), np.int32)
            except Exception as e:  # noqa: BLE001 - a broken env must
                # not kill the other episodes
                logger.warning("Episode %s: env.reset failed: %r",
                               sid, e)
                self.env_errors += 1
                self.dropped.append((sid, "env_error"))
                continue
            self._live[sid] = _Live(sid, env, obs, deadline)

    def _context(self, ep: _Live) -> np.ndarray:
        parts = []
        for t in ep.turns:
            parts.append(t.obs)
            parts.append(t.action)
        parts.append(ep.pending_obs)
        return np.concatenate(parts).astype(np.int32)

    def _drop(self, ep: _Live, reason: str):
        """Drop a live episode, cancelling its in-flight request so
        no client/router state leaks."""
        if ep.rid is not None:
            self._by_rid.pop(ep.rid, None)
            self.client.abandon(ep.rid)
            self.abandoned += 1
            metrics.inc("agentic_abandoned_total", reason=reason)
        self._live.pop(ep.sid, None)
        self.dropped.append((ep.sid, reason))

    def _finish(self, ep: _Live, status: str) -> Episode:
        self._live.pop(ep.sid, None)
        self.episodes_done += 1
        metrics.inc("agentic_episodes_total", status=status)
        return Episode(sid=ep.sid, turns=ep.turns, status=status)

    # ------------------------------------------------------------------
    def pump(self) -> int:
        """Admit new episodes and submit generation for every episode
        awaiting an action. Returns how many requests were
        submitted."""
        self._admit()
        now = self._clock()
        n = 0
        for ep in list(self._live.values()):
            if ep.deadline is not None and now > ep.deadline:
                self._drop(ep, "deadline")
                continue
            if ep.rid is not None:
                continue
            ctx = self._context(ep)
            if self.max_seq_len is not None \
                    and len(ctx) >= self.max_seq_len:
                # context full: no room to act -- keep what we have
                self._live.pop(ep.sid, None)
                if ep.turns:
                    self._finished_overflow.append(
                        self._finish_overflow(ep))
                else:
                    self.dropped.append((ep.sid, "length"))
                continue
            ep.rid = self.client.submit(ctx, ttl=self._ttl)
            self._by_rid[ep.rid] = ep.sid
            n += 1
        return n

    def _finish_overflow(self, ep: _Live) -> Episode:
        self.episodes_done += 1
        metrics.inc("agentic_episodes_total", status="length")
        return Episode(sid=ep.sid, turns=ep.turns, status="length")

    def poll(self, timeout: float = 0.0) -> List[Episode]:
        """Harvest finished generations, step their envs, and return
        every episode that finished."""
        out: List[Episode] = list(self._finished_overflow)
        self._finished_overflow = []
        # harvest first, step envs after: `inflight` must count only
        # requests genuinely still generating at the backend, so the
        # env/generation overlap accounting stays honest (a batched
        # local backend returns everything at once = zero overlap)
        harvested = []
        for res in self.client.poll_results(timeout=timeout):
            sid = self._by_rid.pop(res.rid, None)
            if sid is not None and sid in self._live:
                harvested.append((sid, res))
        for sid, res in harvested:
            if sid not in self._live:
                continue  # dropped while processing an earlier result
            ep = self._live[sid]
            ep.rid = None
            if not res.ok:
                # rejected / draining / expired: backpressure, not an
                # answer -- resubmit the same context (bounded)
                ep.retries += 1
                self.resubmits += 1
                if ep.retries > self.max_retries:
                    self._drop(ep, f"retries:{res.status}")
                continue
            action = np.asarray(res.data["tokens"], np.int32)
            lp = np.asarray(res.data.get("logprobs", ()), np.float32)
            wv = int(res.data.get("weight_version") or 0)
            no_eos = bool(res.data.get("no_eos", False))
            if len(action) == 0:
                self._drop(ep, "empty_action")
                continue
            t0 = self._clock()
            try:
                step = ep.env.step(action)
            except Exception as e:  # noqa: BLE001 - env/tool executor
                # errors drop THIS episode only
                logger.warning("Episode %s: env.step failed: %r",
                               sid, e)
                self.env_errors += 1
                self._drop(ep, "env_error")
                continue
            finally:
                dt = self._clock() - t0
                self.env_step_secs += dt
                if self.inflight > 0:
                    self.env_step_overlap_secs += dt
            ep.turns.append(Turn(
                obs=ep.pending_obs, action=action,
                logprobs=lp[:len(action)], reward=float(step.reward),
                weight_version=wv, no_eos=no_eos))
            self.turns_done += 1
            metrics.inc("agentic_turns_total")
            if step.done:
                out.append(self._finish(ep, "done"))
            elif len(ep.turns) >= self.max_turns:
                if self.drop_on_max_turns:
                    self._drop(ep, "max_turns")
                else:
                    out.append(self._finish(ep, "max_turns"))
            else:
                ep.pending_obs = np.asarray(step.observation, np.int32)
        return out

    def step(self, timeout: float = 0.0) -> List[Episode]:
        self.pump()
        return self.poll(timeout=timeout)

    def run_all(self, deadline_secs: float = 600.0) -> List[Episode]:
        """Drive pump/poll until the episode source is drained; raises
        on stall."""
        deadline = self._clock() + deadline_secs
        out: List[Episode] = []
        while not self.exhausted:
            if self._clock() > deadline:
                raise TimeoutError(
                    f"EpisodeRunner stalled: {self.live} live, "
                    f"{self.inflight} in flight, stats={self.stats()}")
            out.extend(self.step(timeout=0.02))
        return out

    def stop(self) -> int:
        """Abandon every live episode (in-flight requests cancelled);
        returns how many were dropped."""
        n = 0
        for ep in list(self._live.values()):
            self._drop(ep, "stopped")
            n += 1
        return n

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        return dict(
            episodes_done=self.episodes_done,
            turns_done=self.turns_done,
            live=self.live, inflight=self.inflight,
            env_errors=self.env_errors,
            abandoned=self.abandoned,
            resubmits=self.resubmits,
            dropped=len(self.dropped),
            env_step_secs=round(self.env_step_secs, 4),
            env_step_overlap_secs=round(self.env_step_overlap_secs, 4))
