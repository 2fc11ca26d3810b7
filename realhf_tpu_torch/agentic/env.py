"""Environment protocol for environment-in-the-loop (agentic) RL.

Multi-turn rollouts in which generation alternates with an environment
or tool executor. An :class:`Env` speaks in token ids, the currency the
rollout path moves, so the episode loop needs no tokenizer:
``reset()`` gives the initial observation (the prompt),
``step(action_tokens)`` executes the policy's emission and returns the
next observation tokens, the turn's reward, and whether the episode is
over.

Two envs ship:

- :class:`CheckerEnv`: a verifiable-reward task; the answer is a
  deterministic function of the prompt and a programmatic checker is
  the reward model. Single-turn.
- :class:`ToolGameEnv`: a multi-turn tool-call game; each turn the tool
  reveals a target token, the model must emit the structured call
  ``[CALL_TOKEN, arg]``, the env checks the arg against the target,
  rewards the turn and returns the next observation. A malformed call
  earns zero.

Envs are pure host numpy, deterministic given ``(prompt, seed)``; the
registry names them by string, as the dataset and interface registries
do.
"""

import dataclasses
from typing import Any, Callable, Dict, List

import numpy as np

#: conventional special tokens, matching the repo-wide convention that
#: ids 0/1 are pad/eos; envs only emit/expect ids >= 2
PAD_TOKEN = 0
EOS_TOKEN = 1
#: structured tool-call opener the ToolGameEnv requires
CALL_TOKEN = 2
#: marker opening every tool observation
OBS_TOKEN = 3
#: first id usable as task payload
PAYLOAD_BASE = 4


@dataclasses.dataclass
class EnvStep:
    """Result of one environment step.

    ``observation`` tokens are appended to the episode context BEFORE
    the next action (empty when ``done``); ``reward`` is the turn-level
    reward for the action just executed."""
    observation: np.ndarray
    reward: float
    done: bool
    info: Dict[str, Any] = dataclasses.field(default_factory=dict)


class Env:
    """Environment protocol (duck-typed; subclassing is optional).

    Lifecycle: ``reset()`` -> observation tokens; then repeatedly
    ``step(action_tokens)`` -> :class:`EnvStep` until ``done``. An env
    instance drives ONE episode; construct a fresh one per episode
    (``make_env``)."""

    def reset(self) -> np.ndarray:
        raise NotImplementedError

    def step(self, action: np.ndarray) -> EnvStep:
        raise NotImplementedError


ALL_ENV_CLASSES: Dict[str, Callable[..., Env]] = {}


def register_env(name: str, env_cls: Callable[..., Env]):
    if name in ALL_ENV_CLASSES:
        raise ValueError(f"Env {name} already registered.")
    ALL_ENV_CLASSES[name] = env_cls


def make_env(name: str, prompt, seed: int = 0, **kwargs) -> Env:
    """Instantiate a registered env for one episode. ``prompt`` is the
    task specification in token ids (usually a dataset sample's
    ``packed_prompts``); envs derive everything else from it plus
    ``seed``, so episodes are reproducible."""
    if name not in ALL_ENV_CLASSES:
        raise ValueError(
            f"Unknown env `{name}`; registered: "
            f"{sorted(ALL_ENV_CLASSES)}")
    return ALL_ENV_CLASSES[name](prompt=prompt, seed=seed, **kwargs)


def _payload_distance(a: int, b: int, vocab_size: int) -> int:
    """Circular distance within the payload id range."""
    n = max(vocab_size - PAYLOAD_BASE, 1)
    d = abs(int(a) - int(b)) % n
    return min(d, n - d)


class CheckerEnv(Env):
    """Verifiable-reward task: a programmatic checker is the reward
    model. The target is a deterministic function of the prompt:

    - ``task="copy"``: emit the prompt's last token (trivially
      verifiable; learnable by tiny models, so the e2e acceptance
      trains on it);
    - ``task="add"``: emit ``(a + b) mod payload_range`` for the
      prompt's last two tokens -- the GSM-flavored variant.

    The FIRST emitted token is the answer. Reward: 1.0 exact, else
    ``partial_credit * (1 - circular_distance / half_range)`` -- a
    dense, verifiable shaping signal (distance to the checked answer),
    0 for ids outside the payload range. Single-turn: done after one
    step."""

    def __init__(self, prompt, seed: int = 0, *, vocab_size: int = 97,
                 task: str = "copy", partial_credit: float = 0.5):
        if task not in ("copy", "add"):
            raise ValueError(f"CheckerEnv task must be copy|add: {task}")
        self.prompt = np.asarray(prompt, np.int32)
        if len(self.prompt) == 0:
            raise ValueError("CheckerEnv needs a non-empty prompt.")
        self.vocab_size = int(vocab_size)
        self.task = task
        self.partial_credit = float(partial_credit)
        self._done = False

    @property
    def target(self) -> int:
        n = self.vocab_size - PAYLOAD_BASE
        if self.task == "copy":
            t = int(self.prompt[-1])
        else:
            a = int(self.prompt[-1])
            b = int(self.prompt[-2]) if len(self.prompt) > 1 else a
            t = PAYLOAD_BASE + ((a - PAYLOAD_BASE) + (b - PAYLOAD_BASE)) % n
        return t

    def reset(self) -> np.ndarray:
        self._done = False
        return self.prompt.copy()

    def check(self, answer: int) -> float:
        """The programmatic checker: score one candidate answer."""
        t = self.target
        if int(answer) == t:
            return 1.0
        if not (PAYLOAD_BASE <= int(answer) < self.vocab_size):
            return 0.0
        half = max((self.vocab_size - PAYLOAD_BASE) // 2, 1)
        d = _payload_distance(answer, t, self.vocab_size)
        return self.partial_credit * max(0.0, 1.0 - d / half)

    def step(self, action: np.ndarray) -> EnvStep:
        if self._done:
            raise RuntimeError("CheckerEnv episode already finished.")
        self._done = True
        action = np.asarray(action)
        reward = self.check(int(action[0])) if len(action) else 0.0
        return EnvStep(observation=np.zeros(0, np.int32),
                       reward=float(reward), done=True,
                       info=dict(target=self.target))


class ToolGameEnv(Env):
    """Multi-turn toy tool-call game (the echo tool).

    The prompt seeds a hidden target sequence ``t_1..t_n`` (derived
    deterministically from the prompt tokens + ``seed``). Each turn
    the tool's observation ``[OBS_TOKEN, t_k]`` reveals the current
    target; the model must emit the structured call
    ``[CALL_TOKEN, arg]``. The env "executes" the call: a malformed
    emission (missing opener / no arg) earns 0.0; otherwise the arg
    scores 1.0 exact or distance-shaped partial credit. After
    ``n_turns`` calls the episode is done."""

    def __init__(self, prompt, seed: int = 0, *, vocab_size: int = 97,
                 n_turns: int = 3, partial_credit: float = 0.5):
        self.prompt = np.asarray(prompt, np.int32)
        self.vocab_size = int(vocab_size)
        self.n_turns = int(n_turns)
        if self.n_turns < 1:
            raise ValueError(f"n_turns must be >= 1: {n_turns}")
        self.partial_credit = float(partial_credit)
        rng = np.random.default_rng(
            int(np.asarray(prompt, np.int64).sum()) * 1000003 + seed)
        self.targets: List[int] = [
            int(x) for x in rng.integers(PAYLOAD_BASE, self.vocab_size,
                                         size=self.n_turns)]
        self._k = 0

    def _obs(self) -> np.ndarray:
        return np.asarray([OBS_TOKEN, self.targets[self._k]], np.int32)

    def reset(self) -> np.ndarray:
        self._k = 0
        # the prompt (task spec) plus the tool's first observation
        return np.concatenate([self.prompt, self._obs()])

    def step(self, action: np.ndarray) -> EnvStep:
        if self._k >= self.n_turns:
            raise RuntimeError("ToolGameEnv episode already finished.")
        action = np.asarray(action)
        target = self.targets[self._k]
        malformed = len(action) < 2 or int(action[0]) != CALL_TOKEN
        if malformed:
            reward = 0.0
        elif int(action[1]) == target:
            reward = 1.0
        else:
            half = max((self.vocab_size - PAYLOAD_BASE) // 2, 1)
            d = _payload_distance(int(action[1]), target,
                                  self.vocab_size)
            reward = self.partial_credit * max(0.0, 1.0 - d / half)
        self._k += 1
        done = self._k >= self.n_turns
        return EnvStep(
            observation=(np.zeros(0, np.int32) if done else self._obs()),
            reward=float(reward), done=done,
            info=dict(turn=self._k, target=target,
                      malformed=bool(malformed)))


register_env("checker_task", CheckerEnv)
register_env("tool_game", ToolGameEnv)
